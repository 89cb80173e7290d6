"""The multi-card commands on the CPU (--device cpu: gloo processes that the
command starts itself, this process being rank 0): find-mems --mesh
DATAxMODEL for the meshes 1x1, 2x1, 1x2 and 2x2 in the checkpoint and dense
rank modes (with both seed tiers, and once without; reads past the MEM
capacity escalated), stdout byte-equal to the port's find-mems without
--mesh and to the JAX command line's find-mems --mesh 2x2 on the same files
(minus the seconds lines); a malformed --mesh ends in `panidx: invalid
input`, exit 1; merge-tags --engine device in a 2-rank group writes the
bytes of --engine host."""

import sys

import numpy as np
import pytest

import torch_dist_worker as worker
from pangenome_index_tpu import cli as jax_cli
from pangenome_index_tpu_torch import cli
from pangenome_index_tpu_torch.formats import ri, tags as tagfmt
from pangenome_index_tpu_torch.formats.gbz_write import save_gbz
from pangenome_index_tpu_torch.parallel.multihost import spawn_group
from pangenome_index_tpu_torch.utils import synth

MESHES = ["1x1", "2x1", "1x2", "2x2"]


@pytest.fixture(autouse=True)
def short_collectives(monkeypatch):
    monkeypatch.setenv("PANIDX_DIST_TIMEOUT", "60")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synthetic index, its tags and 26 reads (with errors, two short)."""
    d = tmp_path_factory.mktemp("mesh_cli")
    idx, lines = synth.build_synth_index(3000, 3, seed=1)
    (d / "x.ri").write_bytes(ri.serialize_encoded(idx))
    (d / "x.tags").write_bytes(tagfmt.write_compressed_bytecode(synth.synth_tag_array(idx)))
    reads = synth.synth_reads(lines, 24, 60, error_rate=0.02, seed=3)
    (d / "reads.txt").write_bytes(b"\n".join(reads + [lines[0][:8], lines[2][:40]]) + b"\n")
    return d


def argv(d, *extra):
    return ["find-mems", str(d / "x.ri"), str(d / "x.tags"), str(d / "reads.txt"), "12", "1",
            "--tags-format", "bytecode", "--no-mer-cache", *extra]


def without_seconds(out: str) -> bytes:
    return b"\n".join(l for l in out.encode().splitlines() if b"seconds" not in l)


def stdout_of(capfd, main, args):
    capfd.readouterr()
    assert main(args) == 0
    sys.stdout.flush()
    return without_seconds(capfd.readouterr().out)


@pytest.fixture(scope="module")
def single():
    return {}


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
@pytest.mark.parametrize("mesh", MESHES)
def test_find_mems_mesh_matches_one_device_and_jax(files, single, capfd, mesh, mode):
    if mode not in single:
        single[mode] = stdout_of(capfd, cli.main, argv(files, "--device", "cpu",
                                                       "--rank-mode", mode))
    got = stdout_of(capfd, cli.main, argv(files, "--device", "cpu", "--rank-mode", mode,
                                          "--mesh", mesh))
    assert got == single[mode]
    assert got.count(b"MEM START") > got.count(b"Seq: ") > 20
    if mesh == "2x2":
        assert stdout_of(capfd, jax_cli.main, argv(files, "--rank-mode", mode,
                                                   "--mesh", mesh)) == got


def test_find_mems_mesh_without_seed_tiers(files, capfd):
    args = argv(files, "--device", "cpu", "--mer-len", "0", "--long-seed", "0")
    want = stdout_of(capfd, cli.main, args)
    assert stdout_of(capfd, cli.main, [*args, "--mesh", "2x2"]) == want
    assert stdout_of(capfd, jax_cli.main, [*argv(files, "--mer-len", "0", "--long-seed", "0"),
                                           "--mesh", "2x2"]) == want


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_find_mems_mesh_escalates_as_one_device(files, capfd, mesh):
    """Reads past --mem-capacity run again at 128 MEMs a read on the mesh
    and windows past --tag-capacity are queried on the host: the bytes of
    the one-device command, which escalates the same reads."""
    args = argv(files, "--device", "cpu", "--mem-capacity", "2", "--tag-capacity", "2")
    want = stdout_of(capfd, cli.main, args)
    capfd.readouterr()
    assert cli.main([*args, "--mesh", mesh]) == 0
    out = capfd.readouterr()
    assert without_seconds(out.out) == want
    assert "escalated" in out.err and "host refind" not in out.err


@pytest.mark.parametrize("bad", ["2", "2x", "0x2", "twoxtwo"])
def test_malformed_mesh_is_invalid_input(files, capfd, bad):
    capfd.readouterr()
    assert cli.main(argv(files, "--device", "cpu", "--mesh", bad)) == 1
    err = capfd.readouterr().err
    assert err.startswith("panidx: invalid input: --mesh") and "DATAxMODEL" in err


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Two synthetic chromosomes: the whole genome's GBZ and .ri, and each
    component's tags in a directory, built by the port's commands."""
    d = tmp_path_factory.mktemp("mesh_merge")
    whole, subs, _ = synth.synth_multi_component_gbz(1500, 2, n_comps=2, site_rate=0.01,
                                                     seed=3)
    (d / "comp").mkdir()
    for name, g in (("whole", whole), ("c0", subs[0]), ("c1", subs[1])):
        save_gbz(g, d / f"{name}.gbz")
        p = str(d / name)
        for args in (["extract-text", p + ".gbz", "-o", p + ".txt"],
                     ["build-bwt", p + ".txt", p + ".rl_bwt", "--engine", "native"]):
            assert cli.main(args) == 0
        if name != "whole":
            assert cli.main(["build-tags", p + ".gbz", p + ".rl_bwt",
                             str(d / "comp" / f"{name}.tags")]) == 0
    assert cli.main(["build-rindex", str(d / "whole.rl_bwt"), "-o", str(d / "whole.ri")]) == 0
    return d


def test_merge_tags_device_in_a_two_rank_group(genome, tmp_path):
    """merge-tags --engine device run by both ranks of a gloo group: the
    cross-card merge, rank 0's file byte-equal to --engine host's."""
    base = ["merge-tags", str(genome / "whole.gbz"), str(genome / "whole.ri"),
            str(genome / "comp")]
    assert cli.main([*base, str(tmp_path / "host.tags")]) == 0
    out = str(tmp_path / "device.tags")
    assert spawn_group(worker.cli_rank, 2, ([*base, out, "--engine", "device",
                                             "--device", "cpu"],), device="cpu",
                        join_seconds=150) == 0
    host = (tmp_path / "host.tags").read_bytes()
    assert (tmp_path / "device.tags").read_bytes() == host
    assert len(np.frombuffer(host, np.uint8)) > 0
