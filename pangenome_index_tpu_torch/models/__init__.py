"""Host index models of the port (numpy): r-index, tag array, MEM finding."""
