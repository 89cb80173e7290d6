"""Graph-side builds of the port (numpy and the native engine): the GBWT
from paths, the tag array from a graph and an r-index, its k-mer coverage
statistics, and the merge of per-component tag arrays."""
