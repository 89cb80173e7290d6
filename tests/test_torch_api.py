"""The port's public functions against the JAX package's on the CPU: the
route build_index -> to_device -> find_mems, the tables to_device gives
(the same rank fields as the JAX to_device for the same flags), and the
end-to-end demo's output against examples/end_to_end.py."""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pangenome_index_tpu as jpx
import pangenome_index_tpu_torch as px
from pangenome_index_tpu.utils import synth as jsynth
from pangenome_index_tpu_torch import end_to_end, native

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the rank fields that decide which provider the kernels read
RANK_FIELDS = ("rec", "pos_to_run", "bucket_lo", "rank_table", "ckpt")
#: the fields every table form carries
BASE_FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted",
               "last_to_run")


@pytest.fixture(scope="module")
def synth_world():
    """The synthetic index's lines and reads (the host tests' inputs)."""
    _, lines = jsynth.build_synth_index(20_000, 4, seed=2)
    reads = jsynth.synth_reads(lines, 48, 100, error_rate=0.02, seed=5)
    reads[3] = reads[3][:40] + b"N" + reads[3][41:]
    reads[7] = reads[7][:33]
    return lines, reads


def test_facade_route_matches_jax():
    """tests/test_cli.py's facade route, build_index -> to_device(dense=False)
    -> find_mems, on the CPU: the JAX route's tuples."""
    lines = [b"GATTACAGATTACAGT", b"ACTGCCAATGTTTGCC"]
    t = px.to_device(px.build_index(lines), "cpu", dense=False)
    mems = px.find_mems(t, [b"GATTACA"], min_len=4, min_occ=1)
    expect = jpx.find_mems(jpx.to_device(jpx.build_index(lines), dense=False),
                           [b"GATTACA"], min_len=4, min_occ=1)
    assert mems == expect
    assert len(mems) == 1 and all(len(m) == 4 for m in mems[0])


@pytest.mark.parametrize("dense", [True, False])
def test_route_on_synthetic_reads_matches_jax(synth_world, dense):
    """The same route on the synthetic index's 48 reads (errors, an N, a short
    read), through dense records and through bucketed runs: every read's
    (start, end, bwt_start, size) list equals the JAX route's, at capacity 8
    and at the default 64."""
    lines, reads = synth_world
    t = px.to_device(px.build_index(lines), "cpu", dense=dense)
    jt = jpx.to_device(jpx.build_index(lines), dense=dense)
    for capacity in (8, 64):
        got = px.find_mems(t, reads, 20, 1, capacity=capacity)
        assert got == jpx.find_mems(jt, reads, 20, 1, capacity=capacity)
        assert sum(map(len, got)) > len(reads)


def test_to_device_gives_the_jax_rank_fields(synth_world):
    """to_device(idx, "cpu") carries dense records and no bucket_lo, and
    to_device(idx, "cpu", dense=False) bucketed runs (bucket_lo), each field
    present or absent and of the same values as in the JAX to_device's
    tables. (The port's to_device used to give base tables with
    dense=False, which every kernel refuses.)"""
    lines, _ = synth_world
    idx, jidx = px.build_index(lines), jpx.build_index(lines)
    for kw in ({}, {"dense": True}, {"dense": False}, {"dense": False, "checkpoint": True}):
        t, jt = px.to_device(idx, "cpu", **kw), jpx.to_device(jidx, **kw)
        for f in RANK_FIELDS + BASE_FIELDS:
            g, e = getattr(t, f), getattr(jt, f)
            assert (g is None) == (e is None), (kw, f)
            if e is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{kw} {f}")
        assert (t.rec is not None) == kw.get("dense", True)
        assert (t.bucket_lo is not None) == (kw.get("dense", True) is False
                                             and "checkpoint" not in kw)
    # base tables only where the caller asks for them
    assert px.to_device(idx, "cpu", dense=False, bucketed=False).bucket_lo is None


def test_to_device_defaults_to_the_card(synth_world):
    """to_device(idx) places on cuda, as every entry point of the port does,
    and refuses where there is no card; no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    idx = px.build_index(synth_world[0][:1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        px.to_device(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        end_to_end.main()


def test_build_index_raises_where_the_native_build_fails(monkeypatch):
    """build_index has no host-sort fallback: the native build's error
    reaches the caller."""
    def fail(lines):
        raise RuntimeError("native build failed")

    monkeypatch.setattr(native, "build_bwt_native", fail)
    with pytest.raises(RuntimeError, match="native build failed"):
        px.build_index([b"GATTACA"])


def test_end_to_end_prints_what_the_jax_demo_prints():
    """end_to_end.main(device="cpu")'s stdout is byte-equal to
    examples/end_to_end.py's under JAX_PLATFORMS=cpu, and main returns the
    lines it prints."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    expect = subprocess.run([sys.executable, "examples/end_to_end.py"], cwd=REPO, env=env,
                            capture_output=True, timeout=300, check=True).stdout
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = end_to_end.main(device="cpu")
    assert out.getvalue().encode() == expect
    assert lines == expect.decode().splitlines()
    assert len(lines) >= 5 and "MEM [" in lines[-1]
