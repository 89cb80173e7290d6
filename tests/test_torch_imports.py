"""The PyTorch port imports neither jax nor the JAX package: checked in a
fresh interpreter, since this test process has both loaded already
(tests/conftest.py), and in the port's source text."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = """
import importlib, pkgutil, sys
import pangenome_index_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)

# the commands on a small index, through the port's own host route
import numpy as np
from pangenome_index_tpu_torch import cli
from pangenome_index_tpu_torch.formats import ri, tags
from pangenome_index_tpu_torch.utils import synth
d = sys.argv[1]
idx, lines = synth.build_synth_index(3000, 2, seed=1)
open(d + "/x.ri", "wb").write(ri.serialize_encoded(idx))
open(d + "/x.tags", "wb").write(tags.write_compressed_bytecode(synth.synth_tag_array(idx)))
open(d + "/reads.txt", "wb").write(b"\\n".join(synth.synth_reads(lines, 4, 60)) + b"\\n")
common = [d + "/x.ri", d + "/x.tags", d + "/reads.txt"]
assert cli.main(["find-mems", *common, "12", "1", "--device", "cpu",
                 "--tags-format", "bytecode"]) == 0
assert cli.main(["query-tags", *common, "--device", "cpu",
                 "--tags-format", "bytecode"]) == 0
# the multi-card path: the mesh's ranks in gloo processes of their own
assert cli.main(["find-mems", *common, "12", "1", "--device", "cpu",
                 "--tags-format", "bytecode", "--mesh", "1x2"]) == 0
assert cli.main(["build-sdict", d + "/x.ri", "-s", "9", "--device", "cpu"]) == 0
assert np.load(d + "/x.ri.sdict9.npz")["keys"].size > 0
open(d + "/x.txt", "wb").write(b"\\n".join(lines) + b"\\n")
assert cli.main(["build-bwt", d + "/x.txt", d + "/x.rl_bwt", "--device", "cpu"]) == 0
assert cli.main(["build-rindex", d + "/x.rl_bwt", "-o", d + "/y.ri"]) == 0
assert open(d + "/y.ri", "rb").read() == open(d + "/x.ri", "rb").read()
open(d + "/a.tags", "wb").write(tags.write_algorithm(synth.synth_tag_array(idx)))
assert cli.main(["print-stats", d + "/x.ri", d + "/x.tags", "--runtime"]) == 0
assert cli.main(["convert-tags", d + "/a.tags", d + "/c.tags", "--compact"]) == 0
assert cli.main(["tags-check", d + "/x.tags", d + "/c.tags"]) == 0

# the graph commands on a genome of two synthetic chromosomes
import os
from pangenome_index_tpu_torch.formats.gbz_write import save_gbz
whole, subs, _ = synth.synth_multi_component_gbz(1500, 2, n_comps=2, site_rate=0.01, seed=3)
os.mkdir(d + "/comp")
for name, g in (("whole", whole), ("c0", subs[0]), ("c1", subs[1])):
    save_gbz(g, d + f"/{name}.gbz")
    assert cli.main(["extract-text", d + f"/{name}.gbz", "-o", d + f"/{name}.txt"]) == 0
    assert cli.main(["build-bwt", d + f"/{name}.txt", d + f"/{name}.rl_bwt",
                     "--device", "cpu"]) == 0
    assert cli.main(["build-tags", d + f"/{name}.gbz", d + f"/{name}.rl_bwt",
                     d + f"/{name}.tags", "--stats"]) == 0
    assert cli.main(["tags-check", d + f"/{name}.tags", "--verify-gbz", d + f"/{name}.gbz",
                     "--verify-rlbwt", d + f"/{name}.rl_bwt"]) == 0
for c in ("c0", "c1"):
    os.replace(d + f"/{c}.tags", d + f"/comp/{c}.tags")
assert cli.main(["build-rindex", d + "/whole.rl_bwt", "-o", d + "/whole.ri"]) == 0
merged = []
for engine in (["--engine", "host"], ["--engine", "device", "--device", "cpu"]):
    merged.append(d + f"/merged{len(merged)}.tags")
    assert cli.main(["merge-tags", d + "/whole.gbz", d + "/whole.ri", d + "/comp",
                     merged[-1], *engine]) == 0
assert open(merged[0], "rb").read() == open(merged[1], "rb").read()

# the public functions and the end-to-end demo, on the CPU
import pangenome_index_tpu_torch as px
from pangenome_index_tpu_torch import end_to_end
built = px.build_index(lines)
for use_mmap in (False, True):
    assert px.load_rindex(d + "/x.ri", use_mmap=use_mmap).n == built.n
    assert px.load_tags(d + "/x.tags", use_mmap=use_mmap).n_runs > 0
assert px.load_gbz(d + "/whole.gbz").index.sequences == whole.index.sequences
for dense in (True, False):
    t = px.to_device(built, "cpu", dense=dense)
    assert len(px.find_mems(t, synth.synth_reads(lines, 4, 60), 12, 1)) == 4
assert len(end_to_end.main(device="cpu")) >= 5

def foreign(m):
    return (m == "jax" or m.startswith("jax.") or m == "pangenome_index_tpu"
            or m.startswith("pangenome_index_tpu."))
leaked = sorted(m for m in sys.modules if foreign(m))
print(len(names), leaked, file=sys.stderr)
assert not leaked, leaked
assert len(names) >= 20, names
assert "pangenome_index_tpu_torch.parallel.engine" in names
"""

#: an import of the JAX package, or a process started on one of its modules
#: (the port's own package name goes on with "_torch")
FOREIGN = re.compile(
    r"""^\s*(import|from)\s+(jax|pangenome_index_tpu)(\s|\.|$)"""
    r"""|["']-m["']\s*,\s*["']pangenome_index_tpu\.""", re.M)


def test_port_imports_no_jax(tmp_path):
    """Every module of the port (parallel/ too) and its commands (--device
    cpu, find-mems also over a 1x2 mesh; build-rindex, print-stats,
    convert-tags, tags-check, extract-text and build-tags have no device;
    merge-tags on the host and on the CPU device), the public functions and
    the end-to-end demo on the CPU, in a fresh interpreter: no jax and no
    pangenome_index_tpu module gets loaded."""
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "MEM START" in proc.stdout or "read_index=" in proc.stdout


def test_port_sources_name_no_jax_package():
    """chip_smoke.py and every source of the port neither import the JAX
    package nor start a process on it (file:line strings naming the kernels
    they replace are not imports)."""
    sources = [REPO / "chip_smoke.py",
               *sorted((REPO / "pangenome_index_tpu_torch").rglob("*.py"))]
    assert len(sources) > 20
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in sources for m in FOREIGN.finditer(p.read_text())]
    assert not hits, hits
    # the pattern does see what it is meant to see
    for bad in ("import pangenome_index_tpu\n", "from pangenome_index_tpu import x",
                "from pangenome_index_tpu.ops import y", "    import jax.numpy as jnp",
                '[sys.executable, "-m", "pangenome_index_tpu.cli"]'):
        assert FOREIGN.search(bad), bad
    for good in ("import pangenome_index_tpu_torch as port",
                 "from pangenome_index_tpu_torch.ops import mems",
                 '"-m", "pangenome_index_tpu_torch.cli"',
                 '"pangenome_index_tpu/ops/pallas_rank.py:39"'):
        assert not FOREIGN.search(good), good
