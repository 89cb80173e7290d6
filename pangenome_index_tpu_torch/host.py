"""The host side the port takes from the JAX package as it is.

Index models, the alphabet, synthetic data, the native C++ engine and the
numpy build functions live in modules of pangenome_index_tpu that import numpy
only; this module is the one place the port imports them from, so the list
of what is shared stays in one place. Modules of that package that import
jax (ops/tables.py, ops/rank.py, ops/tagquery.py, ...) are never imported:
the port carries its own copies of the few host pieces it needs from them.
"""

from pangenome_index_tpu import native  # noqa: F401
from pangenome_index_tpu.models.rindex import RIndex  # noqa: F401
from pangenome_index_tpu.models.tagarray import TagArray  # noqa: F401
from pangenome_index_tpu.ops.mertable import (  # noqa: F401
    build_mer_table, read_mer_keys_fast)
from pangenome_index_tpu.ops.sparsedict import (  # noqa: F401
    get_sparse_dict, read_windows_fast)
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE, COMP_CODE  # noqa: F401
from pangenome_index_tpu.utils.synth import (  # noqa: F401
    build_synth_index, synth_reads, synth_tag_array)
