"""The port's public functions against the JAX package's on the CPU: the
route build_index -> to_device -> find_mems, the tables to_device gives
(the same rank fields as the JAX to_device for the same flags: dense records
at int32 and at int64 positions, checkpoint rows of 64 and 128 positions,
mem_only stubs), and the end-to-end demo's output against
examples/end_to_end.py."""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
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


@pytest.mark.parametrize("capacity", [8, 64])
def test_int64_dense_route_matches_jax(synth_world, capacity):
    """to_device(idx, "cpu", dtype=torch.int64), dense records at int64
    positions (the form past 2^31), against the JAX to_device(jidx,
    dtype=jnp.int64) under 64-bit types: every rank and base field equal, of
    the same dtype; the lines derived from the int64 pos_to_run (the same as
    the int32 tables'); find_mems on the 48 reads equal to the JAX route's
    and to the int32 tables' at the given capacity."""
    lines, reads = synth_world
    idx = px.build_index(lines)
    t = px.to_device(idx, "cpu", dtype=torch.int64)
    with jax.enable_x64(True):
        jt = jpx.to_device(jpx.build_index(lines), dtype=jnp.int64)
        expect = jpx.find_mems(jt, reads, 20, 1, capacity=capacity)
        jf = {f: None if getattr(jt, f) is None else np.asarray(getattr(jt, f))
              for f in RANK_FIELDS + BASE_FIELDS}
    for f in RANK_FIELDS + BASE_FIELDS:
        g, e = getattr(t, f), jf[f]
        assert (g is None) == (e is None), f
        if e is not None:
            assert g.numpy().dtype == e.dtype, f
            np.testing.assert_array_equal(g.numpy(), e, err_msg=f)
    assert t.pos_dtype == t.rec.dtype == torch.int64
    narrow = px.to_device(idx, "cpu")
    assert torch.equal(t.dense_lines, narrow.dense_lines)
    got = px.find_mems(t, reads, 20, 1, capacity=capacity)
    assert got == expect == px.find_mems(narrow, reads, 20, 1, capacity=capacity)
    assert sum(map(len, got)) > len(reads)


@pytest.mark.parametrize("kw", [dict(checkpoint=True, ckpt_block=128),
                                dict(checkpoint=True, mem_only=True),
                                dict(checkpoint=True, ckpt_block=128, mem_only=True,
                                     dense=False)],
                         ids=["ckpt128", "mem-only", "ckpt128-mem-only-no-dense"])
def test_checkpoint_forms_route_matches_jax(synth_world, kw):
    """to_device with checkpoint rows of 128 positions and with mem_only
    stubs: every rank and base field equal to the JAX to_device's with the
    same flags, and find_mems on the 48 reads equal to the JAX route's and
    to the default tables' (the kernels' 64-position planes of the rows)."""
    lines, reads = synth_world
    idx = px.build_index(lines)
    t = px.to_device(idx, "cpu", **kw)
    jt = jpx.to_device(jpx.build_index(lines), **kw)
    for f in RANK_FIELDS + BASE_FIELDS:
        g, e = getattr(t, f), getattr(jt, f)
        assert (g is None) == (e is None), f
        if e is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f)
    if kw.get("mem_only"):
        assert all(getattr(t, f).shape[0] == 1 for f in BASE_FIELDS if f != "C")
    assert t.ckpt.shape[1] == (24 if kw.get("ckpt_block") == 128 else 16)
    assert t.ckpt_planes.shape[1] == 16
    got = px.find_mems(t, reads, 20, 1, capacity=8)
    assert got == jpx.find_mems(jt, reads, 20, 1, capacity=8)
    assert got == px.find_mems(px.to_device(idx, "cpu"), reads, 20, 1, capacity=8)


def test_to_device_refuses_what_the_jax_one_refuses(synth_world):
    """mem_only without checkpoint rows and a block other than 64 or 128
    raise the JAX package's errors."""
    idx = px.build_index(synth_world[0][:1])
    jidx = jpx.build_index(synth_world[0][:1])
    for kw, msg in ((dict(mem_only=True), "mem_only requires checkpoint mode"),
                    (dict(checkpoint=True, ckpt_block=96), "ckpt_block must be 64 or 128")):
        for call in (lambda: px.to_device(idx, "cpu", **kw), lambda: jpx.to_device(jidx, **kw)):
            with pytest.raises(ValueError, match=msg):
                call()


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
