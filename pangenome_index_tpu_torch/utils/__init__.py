"""Host utilities of the port: the alphabet and the synthetic pangenome."""
