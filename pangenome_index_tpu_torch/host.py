"""The host side the port takes from the JAX package as it is.

Index models, the alphabet, synthetic data, the native C++ engine, the
numpy build functions, the file formats and the command line's host helpers
live in modules of pangenome_index_tpu that import numpy only; this module
is the one place the port imports them from, so the list of what is shared
stays in one place. Modules of that package that import jax (ops/tables.py,
ops/rank.py, ops/tagquery.py, ...) are never imported: the port carries its
own copies of the few host pieces it needs from them.
"""

from pangenome_index_tpu import native  # noqa: F401
from pangenome_index_tpu.cli import (  # noqa: F401
    _load_serving as load_serving, _pack_reads as pack_reads,
    _read_reads as read_reads, _resolve_long_seed as resolve_long_seed)
from pangenome_index_tpu.formats import ri, tags as tagfmt  # noqa: F401
from pangenome_index_tpu.models.mems import find_all_mems  # noqa: F401
from pangenome_index_tpu.models.rindex import RIndex  # noqa: F401
from pangenome_index_tpu.models.tagarray import TagArray  # noqa: F401
from pangenome_index_tpu.ops.mertable import (  # noqa: F401
    build_mer_table, mer_table_key, read_mer_keys_fast)
from pangenome_index_tpu.ops.sparsedict import (  # noqa: F401
    DEVICE_BYTES_CAP, get_sparse_dict, read_windows_fast)
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE, COMP_CODE  # noqa: F401
from pangenome_index_tpu.utils.synth import (  # noqa: F401
    build_synth_index, synth_reads, synth_tag_array)
