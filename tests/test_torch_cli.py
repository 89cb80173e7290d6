"""The port's find-mems and query-tags commands end to end against the JAX
package's: stdout byte-equal to `--engine native` and `--engine host`
(minus the "Total time ... seconds" lines), on the synthetic graph pipeline
of tests/test_cli.py (CPU: --device cpu runs the kernels' plain versions);
the other commands likewise (the formats-only print-stats, convert-tags and
tags-check, and the graph commands extract-text, build-tags, tags-check
--verify-gbz and merge-tags: stdout, the written file and the exit code;
stderr too, without the seconds lines).

The commands run in this process with the output descriptors captured
(capfd), apart from one run of `python -m pangenome_index_tpu_torch.cli`
that checks the entry point."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pangenome_index_tpu import cli as jax_cli
from pangenome_index_tpu.core.gbwt_build import random_pangenome_gbz
from pangenome_index_tpu.formats.gbz_write import save_gbz
from pangenome_index_tpu.utils.synth import synth_multi_component_gbz
from pangenome_index_tpu_torch import cli
from pangenome_index_tpu_torch.formats import tags as port_tags

REPO = pathlib.Path(__file__).resolve().parent.parent
MIN_LEN, MIN_OCC = "10", "1"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """GBZ -> text -> BWT -> r-index -> tags through the JAX commands, and a
    reads file: haplotype substrings (two short enough to span many tag
    runs), substrings with substitutions (several MEMs per read), one with
    an N, and one that does not occur."""
    d = tmp_path_factory.mktemp("torch_cli")
    save_gbz(random_pangenome_gbz(np.random.default_rng(23), n_nodes=40,
                                  n_paths=3), d / "synth.gbz")
    for argv in (["extract-text", "synth.gbz", "-o", "synth.txt"],
                 ["build-bwt", "synth.txt", "synth.rl_bwt"],
                 ["build-rindex", "synth.rl_bwt", "-o", "synth.ri"],
                 ["build-tags", "synth.gbz", "synth.rl_bwt", "synth.tags"],
                 ["convert-tags", "synth.tags", "synth_c.tags", "--compact",
                  "--no-compat"]):
        assert jax_cli.main([a if a.startswith("-") else
                             str(d / a) if "." in a else a for a in argv]) == 0
    lines = [l for l in (d / "synth.txt").read_bytes().split(b"\n") if l]
    rng = np.random.default_rng(5)
    reads = [lines[0][:30], lines[-1][5:35], lines[0][10:40], lines[-1][:30],
             lines[1][:4], lines[2][7:12]]
    for _ in range(8):
        line = lines[int(rng.integers(len(lines)))]
        s = int(rng.integers(0, max(len(line) - 60, 1)))
        r = bytearray(line[s : s + 60])
        for p in rng.integers(0, len(r), 3):
            r[p] = b"ACGT"[(b"ACGT".index(r[p]) + 1) % 4]
        reads.append(bytes(r))
    reads += [lines[1][3:25] + b"N" + lines[1][26:40], b"ACGTTGCAACGTTGCAACGTTGCA"]
    (d / "reads.txt").write_bytes(b"\n".join(reads) + b"\n")
    return d


def paths(d, cmd):
    return [cmd, str(d / "synth.ri"), str(d / "synth_c.tags"), str(d / "reads.txt")]


def mem_args(d):
    return [*paths(d, "find-mems"), MIN_LEN, MIN_OCC]


def without_seconds(out: bytes) -> bytes:
    return b"\n".join(l for l in out.splitlines() if b"seconds" not in l)


def jax_stdout(capfd, argv):
    capfd.readouterr()
    assert jax_cli.main(argv) == 0
    sys.stdout.flush()
    return without_seconds(capfd.readouterr().out.encode())


def port_run(capfd, argv, seconds=None):
    """(stdout without the seconds lines, stderr) of the port's command."""
    capfd.readouterr()
    assert cli.main([*argv, "--device", "cpu"], seconds) == 0
    out = capfd.readouterr()
    return without_seconds(out.out.encode()), out.err


@pytest.fixture(scope="module")
def expected():
    return {}


def reference(expected, capfd, d, cmd):
    """The JAX commands' stdout, once per command; native and host agree."""
    if cmd not in expected:
        argv = mem_args(d) if cmd == "find-mems" else paths(d, cmd)
        native = jax_stdout(capfd, [*argv, "--engine", "native"])
        host = jax_stdout(capfd, [*argv, "--engine", "host"])
        assert native == host
        expected[cmd] = native
    return expected[cmd]


@pytest.mark.parametrize("extra", [
    [], ["--batch-size", "2", "--mer-len", "4"], ["--mem-capacity", "1"],
    ["--tag-capacity", "1"], ["--rank-mode", "dense"], ["--engine", "device"],
    ["--rank-mode", "ultra"], ["--rank-mode", "bucketed"]],
    ids=["defaults", "sorted-chunks", "escalation", "tag-requery", "dense",
         "engine-device", "ultra", "bucketed"])
# "sorted-chunks": the JAX command sorts its reads by work across chunks and
# permutes the results back; the port serves the chunks in input order
def test_find_mems_matches_jax(files, expected, capfd, extra):
    want = reference(expected, capfd, files, "find-mems")
    seconds = {}
    got, err = port_run(capfd, [*mem_args(files), *extra], seconds)
    assert got == want
    assert want.count(b"MEM START") > want.count(b"Seq: ")
    assert {"load", "tables", "mems", "tags", "output"} <= set(seconds)
    assert ("escalated" in err) == (extra == ["--mem-capacity", "1"])


@pytest.mark.parametrize("extra", [[], ["--tag-capacity", "1"], ["--engine", "device"]],
                         ids=["defaults", "tag-requery", "engine-device"])
def test_query_tags_matches_jax(files, expected, capfd, extra):
    want = reference(expected, capfd, files, "query-tags")
    got, err = port_run(capfd, [*paths(files, "query-tags"), *extra])
    assert got == want
    assert "Read 14 has no matches" in err and "Read 15 has no matches" in err
    runs = [int(x) for x in re.findall(rb"runs=(-?\d+)", want)]
    assert len(runs) >= 6 and max(runs) > 1  # capacity 1 overflows there


def test_entry_point_and_refusals(files, expected, capfd):
    """`python -m pangenome_index_tpu_torch.cli` gives the same bytes; a
    missing card is an error, not a fallback to the CPU."""
    want = reference(expected, capfd, files, "find-mems")
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-m", "pangenome_index_tpu_torch.cli",
                           *mem_args(files), "--device", "cpu"], env=env,
                          capture_output=True, timeout=300, check=True)
    assert without_seconds(proc.stdout) == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(mem_args(files))


#: every (command, engine) pair of the reference's --engine choices besides
#: device, which the cases above hold
REFERENCE_ENGINES = [("find-mems", "host"), ("find-mems", "native"),
                     ("query-tags", "host"), ("query-tags", "native"),
                     ("build-sdict", "host"), ("build-bwt", "native"),
                     ("build-bwt", "host")]


def no_seconds(err: str) -> str:
    """build-sdict's stderr summary without its "(x.ys)" seconds."""
    return re.sub(r" \(\d+\.\ds\)$", "", err.strip().splitlines()[-1])


@pytest.mark.parametrize("cmd,engine", REFERENCE_ENGINES,
                         ids=[f"{c}-{e}" for c, e in REFERENCE_ENGINES])
def test_reference_engines_match_jax(files, capfd, tmp_path, cmd, engine):
    """Each --engine choice of the reference besides device gives the JAX
    command line's output under the same engine: find-mems' and
    query-tags' stdout (minus the seconds lines) and stderr, build-sdict's
    file (its arrays and content key) and summary line, build-bwt's .rl_bwt
    bytes and summary line. The port's commands run with no --device, whose
    default (cuda) these engines never read: nothing goes to a device."""
    argv = [cmd, str(files / "synth.ri")]
    outs = ["-o", str(tmp_path / "jax.npz")], ["-o", str(tmp_path / "port.npz")]
    if cmd == "build-bwt":
        argv = [cmd, str(files / "synth.txt")]
        outs = [str(tmp_path / "jax.rl_bwt")], [str(tmp_path / "port.rl_bwt")]
    elif cmd == "build-sdict":
        argv += ["-s", "7", "--min-keep", "2"]
    else:
        argv = mem_args(files) if cmd == "find-mems" else paths(files, cmd)
        outs = [], []
    capfd.readouterr()
    assert jax_cli.main([*argv, *outs[0], "--engine", engine]) == 0
    sys.stdout.flush()
    want = capfd.readouterr()
    seconds = {}
    assert cli.main([*argv, *outs[1], "--engine", engine], seconds) == 0
    got = capfd.readouterr()
    assert "cuda" not in got.err and "Traceback" not in got.err
    if cmd in ("find-mems", "query-tags"):
        assert without_seconds(got.out.encode()) == without_seconds(want.out.encode())
        assert got.err == want.err
        assert seconds.keys() == {"load", "output"}
        if cmd == "find-mems":
            assert got.out.count("MEM START") > got.out.count("Seq: ") > 0
        else:
            assert "Read 14 has no matches" in got.err
    elif cmd == "build-sdict":
        assert no_seconds(got.err).replace(outs[1][1], "OUT") == \
            no_seconds(want.err).replace(outs[0][1], "OUT")
        with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
            assert sorted(p.files) == sorted(j.files) == ["key", "keys", "vals"]
            for f in p.files:
                assert p[f].dtype == j[f].dtype
                np.testing.assert_array_equal(p[f], j[f])
            assert p["keys"].size > 0
    else:
        assert last_line(got.err) == last_line(want.err)
        assert (tmp_path / "port.rl_bwt").read_bytes() == \
            (tmp_path / "jax.rl_bwt").read_bytes() == (files / "synth.rl_bwt").read_bytes()


@pytest.mark.parametrize("s,keep", [(7, 2), (9, 1)])
def test_build_sdict_device_ships_mem_only_tables(files, capfd, tmp_path, monkeypatch, s,
                                                  keep):
    """build-sdict --engine device asks for checkpoint rows with mem_only, as
    the JAX command does (pangenome_index_tpu/cli.py): its tables carry
    one-row stubs of the per-run and locate tables, and its file and summary
    line equal the JAX command line's --engine device, and the file equals
    the one the command writes through the full tables."""
    from pangenome_index_tpu_torch.ops import tables as port_tables

    made = []

    def rindex(idx, device, **kw):
        made.append((kw, port_tables.rindex_to_device(idx, device, **kw)))
        return made[-1][1]

    monkeypatch.setattr(cli, "rindex_to_device", rindex)
    argv = ["build-sdict", str(files / "synth.ri"), "-s", str(s), "--min-keep", str(keep)]
    capfd.readouterr()
    assert jax_cli.main([*argv, "-o", str(tmp_path / "jax.npz"), "--engine", "device"]) == 0
    sys.stdout.flush()
    want = capfd.readouterr()
    assert cli.main([*argv, "-o", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    got = capfd.readouterr()
    kw, t = made[-1]
    assert kw == dict(checkpoint=True, mem_only=True)
    assert all(getattr(t, f).shape[0] == 1 for f in (
        "run_sym", "run_start", "cum", "samples", "last_sorted", "last_to_run"))
    assert no_seconds(got.err).replace(str(tmp_path / "port.npz"), "OUT") == \
        no_seconds(want.err).replace(str(tmp_path / "jax.npz"), "OUT")
    # the same command over the full tables (mem_only dropped)
    monkeypatch.setattr(cli, "rindex_to_device", lambda idx, device, mem_only, **kw:
                        port_tables.rindex_to_device(idx, device, **kw))
    assert cli.main([*argv, "-o", str(tmp_path / "full.npz"), "--device", "cpu"]) == 0
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "full.npz") as full:
        assert sorted(p.files) == sorted(j.files) == ["key", "keys", "vals"]
        for f in p.files:
            assert p[f].dtype == j[f].dtype
            np.testing.assert_array_equal(p[f], j[f])
            np.testing.assert_array_equal(p[f], full[f])
        assert p["keys"].size > 0


def test_build_sdict_host_equals_the_device_build(files, tmp_path):
    """build-sdict --engine host writes the file of the device engine (here
    its plain levels on the CPU): the same arrays under the same key."""
    ri_path = str(files / "synth.ri")
    for engine, extra in (("host", []), ("device", ["--device", "cpu"])):
        assert cli.main(["build-sdict", ri_path, "-s", "9", "-o",
                         str(tmp_path / f"{engine}.npz"), "--engine", engine, *extra]) == 0
    with np.load(tmp_path / "host.npz") as h, np.load(tmp_path / "device.npz") as d:
        for f in ("key", "keys", "vals"):
            np.testing.assert_array_equal(h[f], d[f])


@pytest.mark.parametrize("cmd", ["find-mems", "query-tags", "build-sdict", "build-bwt"])
def test_engine_choices_are_the_references(capfd, cmd):
    """--engine lists the reference's choices for each command and refuses
    any other (the parser's exit code 2)."""
    want = {"find-mems": "device,host,native", "query-tags": "device,host,native",
            "build-sdict": "device,host", "build-bwt": "device,native,host"}[cmd]
    capfd.readouterr()
    with pytest.raises(SystemExit):
        cli.main([cmd, "--help"])
    assert "{" + want + "}" in capfd.readouterr().out
    with pytest.raises(SystemExit) as exc:
        cli.main([cmd, "x", "y", "--engine", "oracle"])
    assert exc.value.code == 2
    assert "invalid choice" in capfd.readouterr().err


def test_chunk_rule():
    """chunk_size: at most the cap, no more than half the budget holds, at
    least one; no budget (the CPU) leaves the cap."""
    per_read = cli.read_bytes(150, 32)
    assert cli.chunk_size(16384, per_read, cli.READ_CHUNK, None) == 4096
    assert cli.chunk_size(100, per_read, cli.READ_CHUNK, None) == 100
    assert cli.chunk_size(16384, per_read, cli.READ_CHUNK, 2 * 1000 * per_read) == 1000
    assert cli.chunk_size(16384, per_read, cli.READ_CHUNK, 10**12) == 4096
    assert cli.chunk_size(5, per_read, cli.READ_CHUNK, 1) == 1
    assert cli.read_bytes(150, 1024) > cli.read_bytes(150, 32) > cli.read_bytes(20, 32)
    assert cli.interval_bytes(256) == 8 + 256 * 8 + 9


@pytest.mark.parametrize("extra", [[], ["--mem-capacity", "1"]],
                         ids=["defaults", "escalation"])
def test_find_mems_in_chunks_under_a_small_budget(files, expected, capfd,
                                                   monkeypatch, extra):
    """--batch-size 0 under a device budget that holds three reads a launch:
    the reads and the tag intervals go in several chunks, in order, and
    stdout is byte-equal to the unchunked run and to the JAX command line's
    --engine native."""
    want = reference(expected, capfd, files, "find-mems")
    unchunked, _ = port_run(capfd, [*mem_args(files), *extra, "--batch-size", "1000"])
    codes, lens = cli.pack_reads(cli.read_reads(str(files / "reads.txt")))
    cap = 1 if extra else 32
    budget = 2 * 3 * cli.read_bytes(codes.shape[1], cap)
    assert cli.chunk_size(len(lens), cli.read_bytes(codes.shape[1], cap),
                          cli.READ_CHUNK, budget) == 3
    reads_a_launch, intervals_a_launch = [], []
    find_mems, query_tags_batch = cli.find_mems, cli.query_tags_batch

    def counted_find_mems(t, codes, *a, **k):
        reads_a_launch.append((codes.shape[0], k["capacity"]))
        return find_mems(t, codes, *a, **k)

    def counted_query_tags_batch(tt, start, end, **k):
        intervals_a_launch.append(start.shape[0])
        return query_tags_batch(tt, start, end, **k)

    monkeypatch.setattr(cli, "find_mems", counted_find_mems)
    monkeypatch.setattr(cli, "query_tags_batch", counted_query_tags_batch)
    monkeypatch.setattr(cli, "device_budget", lambda dev: budget)
    got, err = port_run(capfd, [*mem_args(files), *extra])
    assert got == unchunked == want
    first = [n for n, c in reads_a_launch if c == cap]
    assert first == [3] * (len(lens) // 3) + [len(lens) % 3] * (len(lens) % 3 > 0)
    assert all(n == 1 or n * cli.read_bytes(codes.shape[1], c) <= budget // 2
               for n, c in reads_a_launch)
    assert ("escalated" in err) == bool(extra)
    assert len(intervals_a_launch) > 1
    assert max(intervals_a_launch) == budget // (2 * cli.interval_bytes(256))


def run_both(capfd, jax_argv, port_argv):
    """((exit code, stderr) of the JAX command, the same of the port's)."""
    capfd.readouterr()
    jax_rc = jax_cli.main(jax_argv)
    jax_err = capfd.readouterr().err
    port_rc = cli.main([*port_argv, "--device", "cpu"])
    return (jax_rc, jax_err), (port_rc, capfd.readouterr().err)


def last_line(err: str) -> str:
    return err.strip().splitlines()[-1]


@pytest.mark.parametrize("cmd,missing", [("find-mems", "ri"), ("find-mems", "tags"),
                                         ("find-mems", "reads"), ("query-tags", "ri"),
                                         ("query-tags", "tags"), ("build-sdict", "ri")])
def test_missing_file_is_panidx_error(files, capfd, cmd, missing):
    """A missing input ends both command lines with `panidx: <the OS's
    message>` on stderr and exit code 1, not with a traceback."""
    gone = str(files / "nowhere" / "missing.bin")
    named = {"ri": str(files / "synth.ri"), "tags": str(files / "synth_c.tags"),
             "reads": str(files / "reads.txt")}
    named[missing] = gone
    if cmd == "build-sdict":
        argv = [cmd, named["ri"]]
        engine = ["--engine", "host"]
    else:
        argv = [cmd, named["ri"], named["tags"], named["reads"]]
        argv += [MIN_LEN, MIN_OCC] if cmd == "find-mems" else []
        engine = ["--engine", "host"]
    (jax_rc, jax_err), (port_rc, port_err) = run_both(capfd, argv + engine, argv)
    assert jax_rc == port_rc == 1
    assert last_line(port_err) == last_line(jax_err)
    assert last_line(port_err).startswith("panidx: ") and gone in port_err
    assert "Traceback" not in port_err


@pytest.mark.parametrize("cmd", ["find-mems", "query-tags"])
def test_bad_tag_payload_is_invalid_input(files, capfd, tmp_path, cmd):
    """A tag file that cannot be decoded: `panidx: invalid input: ...`, exit
    code 1, the JAX command line's words."""
    bad = tmp_path / "bad.tags"
    bad.write_bytes((files / "synth_c.tags").read_bytes()[:37])
    argv = [cmd, str(files / "synth.ri"), str(bad), str(files / "reads.txt")]
    argv += [MIN_LEN, MIN_OCC] if cmd == "find-mems" else []
    (jax_rc, jax_err), (port_rc, port_err) = run_both(
        capfd, [*argv, "--engine", "host"], argv)
    assert jax_rc == port_rc == 1
    assert last_line(port_err) == last_line(jax_err)
    assert last_line(port_err).startswith("panidx: invalid input: ")


@pytest.fixture
def two_level(monkeypatch):
    """The commands' tables made as at n >= 2^31: int64 positions over
    two-level checkpoint rows (superblocks of 2^7 positions, so that the
    small index spans many) and int64 tag run heads. Returns the tables the
    commands made."""
    from pangenome_index_tpu_torch.ops import tables as port_tables

    made = []

    def rindex(idx, device, **kw):
        made.append(port_tables.rindex_to_device(idx, device, super_shift=7,
                                                 dtype=torch.int64, **kw))
        return made[-1]

    def tags(t, device):
        made.append(port_tables.tags_to_device(t, device, dtype=torch.int64))
        return made[-1]

    monkeypatch.setattr(cli, "rindex_to_device", rindex)
    monkeypatch.setattr(cli, "tags_to_device", tags)
    return made


@pytest.mark.parametrize("extra", [[], ["--mem-capacity", "1"]],
                         ids=["defaults", "escalation"])
def test_find_mems_two_level_int64_matches_jax(files, expected, capfd, two_level,
                                               extra):
    """find-mems served through int64 tables over two-level checkpoint rows
    (the n >= 2^31 form) prints the JAX command line's native bytes."""
    want = reference(expected, capfd, files, "find-mems")
    got, _ = port_run(capfd, [*mem_args(files), *extra])
    assert got == want
    t = two_level[0]
    assert t.pos_dtype == torch.int64 and t.super_S.shape[0] > 4
    assert two_level[1].bwt_start.dtype == torch.int64


def test_query_tags_two_level_int64_matches_jax(files, expected, capfd, two_level):
    want = reference(expected, capfd, files, "query-tags")
    got, _ = port_run(capfd, paths(files, "query-tags"))
    assert got == want
    assert two_level[0].pos_dtype == two_level[1].bwt_start.dtype == torch.int64


def test_build_sdict_two_level_int64(files, capfd, two_level, tmp_path):
    """build-sdict through int64 two-level tables writes the host build's
    dictionary (values compared as integers: the host build keeps int32
    below 2^31)."""
    from pangenome_index_tpu_torch.formats import ri
    from pangenome_index_tpu_torch.ops.sparsedict import build_sparse_dict

    out = tmp_path / "two_level.npz"
    capfd.readouterr()
    assert cli.main(["build-sdict", str(files / "synth.ri"), "-o", str(out), "-s", "9",
                     "--device", "cpu"]) == 0
    keys, vals = build_sparse_dict(ri.load_file(str(files / "synth.ri")), 9)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["keys"], keys)
        np.testing.assert_array_equal(z["vals"], vals)
        assert z["vals"].dtype == np.int64 and len(keys) > 0
    assert two_level[0].pos_dtype == torch.int64


@pytest.mark.parametrize("n", [2**31 - 1, 2**31])
def test_rank_mode_past_int32_follows_the_reference(files, capfd, monkeypatch, n):
    """The rank tables find-mems builds for each --rank-mode, below and at
    n = 2^31, are the JAX command line's: dense and ultra resolve to
    bucketed at n >= 2^31, checkpoint and bucketed stay themselves. Both
    commands are stopped where they ask for their tables, their index a
    stand-in of n positions."""
    from types import SimpleNamespace

    from pangenome_index_tpu.ops import tables as jax_tables

    class Stop(Exception):
        pass

    asked = {"jax": [], "port": []}

    def recorder(which):
        def rindex_to_device(idx, *args, **kw):
            asked[which].append(sorted(k for k, v in kw.items() if v is True))
            raise Stop
        return rindex_to_device

    stand_in = SimpleNamespace(n=n, n_seq=1, max_len=n)
    monkeypatch.setenv("PANIDX_XLA_CACHE", "")
    monkeypatch.setattr(jax_cli, "_load_serving", lambda args: (stand_in, None))
    monkeypatch.setattr(jax_tables, "rindex_to_device", recorder("jax"))
    monkeypatch.setattr(cli, "load_serving", lambda args: (stand_in, None))
    monkeypatch.setattr(cli, "rindex_to_device", recorder("port"))
    modes = ("checkpoint", "dense", "ultra", "bucketed")
    for mode in modes:
        for main, extra in ((jax_cli.main, ["--engine", "device"]),
                            (cli.main, ["--device", "cpu"])):
            with pytest.raises(Stop):
                main([*mem_args(files), "--rank-mode", mode, *extra])
    capfd.readouterr()
    # the JAX command passes no flag for bucketed (its default)
    jax_modes = [a[0] if a else "bucketed" for a in asked["jax"]]
    assert jax_modes == [cli.rank_mode_for(n, m) for m in modes]
    assert asked["port"] == [[m] for m in jax_modes]
    assert jax_modes == (["checkpoint", "bucketed", "bucketed", "bucketed"] if n >= 2**31
                         else list(modes))


def test_find_mems_uses_a_prebuilt_dictionary(files, expected, capfd):
    """build-sdict's default artifact is the file find-mems --long-seed reads:
    the second command builds no dictionary and prints the same bytes."""
    from pangenome_index_tpu_torch.ops import sparsedict as sd

    want = reference(expected, capfd, files, "find-mems")
    s = int(MIN_LEN) - 1
    artifact = files / f"synth.ri.sdict{s}.npz"
    artifact.unlink(missing_ok=True)
    assert cli.main(["build-sdict", str(files / "synth.ri"), "--min-len", MIN_LEN,
                     "--device", "cpu"]) == 0
    assert artifact.exists()
    stamp = artifact.stat().st_mtime_ns

    def no_build(*a, **k):
        raise AssertionError("find-mems rebuilt a dictionary it had on disk")

    try:
        real, sd.build_sparse_dict_device = sd.build_sparse_dict_device, no_build
        got, _ = port_run(capfd, [*mem_args(files), "--mer-len", "4"])
    finally:
        sd.build_sparse_dict_device = real
    assert got == want and artifact.stat().st_mtime_ns == stamp


@pytest.mark.parametrize("engine", ["native", "device", "host"])
def test_build_bwt_matches_jax(files, capfd, tmp_path, engine):
    """build-bwt --device cpu writes the JAX command line's .rl_bwt, byte for
    byte, under each of its engines, with its stderr summary line; the
    phases are read, build, write."""
    text = str(files / "synth.txt")
    seconds = {}
    capfd.readouterr()
    assert jax_cli.main(["build-bwt", text, str(tmp_path / "jax.rl_bwt"),
                         "--engine", engine]) == 0
    jax_err = capfd.readouterr().err
    assert cli.main(["build-bwt", text, str(tmp_path / "port.rl_bwt"), "--device",
                     "cpu"], seconds) == 0
    port_err = capfd.readouterr().err
    assert (tmp_path / "port.rl_bwt").read_bytes() == (tmp_path / "jax.rl_bwt").read_bytes()
    assert (tmp_path / "port.rl_bwt").read_bytes() == (files / "synth.rl_bwt").read_bytes()
    assert last_line(port_err) == last_line(jax_err)
    assert last_line(port_err).startswith("build-bwt: ")
    assert set(seconds) == {"read", "build", "write"}


def test_build_bwt_of_an_empty_text(files, capfd, tmp_path):
    """An empty text gives the empty file and summary of the JAX command
    line's default (native) engine."""
    (tmp_path / "empty.txt").write_bytes(b"\n\n")
    (jax_rc, jax_err), (port_rc, port_err) = run_both(
        capfd, ["build-bwt", str(tmp_path / "empty.txt"), str(tmp_path / "jax.rl_bwt")],
        ["build-bwt", str(tmp_path / "empty.txt"), str(tmp_path / "port.rl_bwt")])
    assert jax_rc == port_rc == 0 and last_line(port_err) == last_line(jax_err)
    assert (tmp_path / "port.rl_bwt").read_bytes() == (tmp_path / "jax.rl_bwt").read_bytes()


@pytest.mark.parametrize("fmt", ["encoded", "legacy"])
def test_build_rindex_matches_jax(files, capfdbinary, fmt):
    """build-rindex prints the JAX command's .ri bytes on stdout, both
    formats, with its stderr summary line."""
    argv = ["build-rindex", str(files / "synth.rl_bwt"), "--format", fmt]
    capfdbinary.readouterr()
    assert jax_cli.main(argv) == 0
    sys.stdout.flush()
    want = capfdbinary.readouterr()
    seconds = {}
    assert cli.main(argv, seconds) == 0
    got = capfdbinary.readouterr()
    assert got.out == want.out and len(got.out) > 100
    assert got.err.splitlines()[-1] == want.err.splitlines()[-1]
    assert got.err.startswith(b"r-index: ")
    assert set(seconds) == {"read", "build", "write"}
    if fmt == "encoded":
        assert got.out == (files / "synth.ri").read_bytes()


def test_text_to_index_serves_the_same(files, expected, capfd, tmp_path):
    """The port's text -> .rl_bwt -> .ri: the .ri is byte-equal to the one
    that utils/synth's route (native SA-IS, build_rindex_from_sa) makes of
    the same lines and to the JAX pipeline's, and find-mems on it prints
    the JAX command line's bytes."""
    from pangenome_index_tpu_torch import native
    from pangenome_index_tpu_torch.formats import ri as port_ri
    from pangenome_index_tpu_torch.formats.rlbwt import rlbwt_from_text
    from pangenome_index_tpu_torch.models.rindex import build_rindex_from_sa

    want = reference(expected, capfd, files, "find-mems")
    assert cli.main(["build-bwt", str(files / "synth.txt"), str(tmp_path / "t.rl_bwt"),
                     "--device", "cpu"]) == 0
    assert cli.main(["build-rindex", str(tmp_path / "t.rl_bwt"), "-o",
                     str(tmp_path / "t.ri")]) == 0
    built = (tmp_path / "t.ri").read_bytes()
    lines = [l for l in (files / "synth.txt").read_bytes().split(b"\n") if l]
    b, da, sa_pos, seq_lengths = native.build_bwt_native(lines)
    synth_ri = port_ri.serialize_encoded(build_rindex_from_sa(
        rlbwt_from_text(b.tobytes()), da, sa_pos, seq_lengths))
    assert built == synth_ri == (files / "synth.ri").read_bytes()
    argv = mem_args(files)
    argv[1] = str(tmp_path / "t.ri")
    got, _ = port_run(capfd, argv)
    assert got == want


@pytest.mark.parametrize("case", ["missing-text", "missing-rl_bwt", "byte-outside"])
def test_build_errors_are_panidx_errors(files, capfd, tmp_path, case):
    """A missing text or .rl_bwt, and an .rl_bwt holding a byte outside
    {\\n,A,C,G,N,T}: the JAX command line's stderr line, exit code 1."""
    gone = str(tmp_path / "nowhere" / "missing")
    if case == "missing-text":
        jax_argv = port_argv = ["build-bwt", gone, str(tmp_path / "x.rl_bwt")]
        port_argv = [*port_argv, "--device", "cpu"]
    else:
        path = gone
        if case == "byte-outside":
            path = str(tmp_path / "bad.rl_bwt")
            data = bytearray((files / "synth.rl_bwt").read_bytes())
            rec = int(np.frombuffer(bytes(data[:16]), np.uint64).sum())
            data[16 + 3 * rec] = ord("X")  # the fourth run's symbol byte
            open(path, "wb").write(bytes(data))
        jax_argv = port_argv = ["build-rindex", path, "-o", str(tmp_path / "x.ri")]
    capfd.readouterr()
    assert jax_cli.main(jax_argv) == 1
    jax_err = capfd.readouterr().err
    assert cli.main(port_argv) == 1
    port_err = capfd.readouterr().err
    assert last_line(port_err) == last_line(jax_err)
    assert last_line(port_err).startswith("panidx: ")
    assert "Traceback" not in port_err
    if case == "byte-outside":
        assert "outside" in port_err


def both_outputs(capfd, argv):
    """((exit code, stdout, stderr) of the JAX command line, the same of
    the port's) for one argv; the formats-only commands take no --device."""
    capfd.readouterr()
    jax_rc = jax_cli.main(argv)
    sys.stdout.flush()
    jax_out = capfd.readouterr()
    port_rc = cli.main(argv)
    sys.stdout.flush()
    port_out = capfd.readouterr()
    return (jax_rc, jax_out.out, jax_out.err), (port_rc, port_out.out, port_out.err)


@pytest.fixture(scope="module")
def legacy_ri(files):
    """The synthetic graph's r-index in the legacy format, by the JAX
    command line."""
    path = files / "synth_legacy.ri"
    if not path.exists():
        assert jax_cli.main(["build-rindex", str(files / "synth.rl_bwt"), "-o", str(path),
                             "--format", "legacy"]) == 0
    return path


PRINT_STATS = {"ri": ("synth.ri", None, []), "ri-runtime": ("synth.ri", None, ["--runtime"]),
               "bytecode-tags": ("synth.ri", "synth_c.tags", []),
               "algorithm-tags-runtime": ("synth.ri", "synth.tags", ["--runtime"]),
               "legacy-ri-tags-runtime": ("legacy", "synth_c.tags", ["--runtime"])}


@pytest.mark.parametrize("case", list(PRINT_STATS))
def test_print_stats_matches_jax(files, legacy_ri, capfd, case):
    """print-stats prints the JAX command line's bytes, with and without a
    tag file (bytecode and algorithm formats) and --runtime, on the encoded
    and the legacy .ri; its sections sum to the files' sizes."""
    ri_name, tags_name, extra = PRINT_STATS[case]
    ri_path = legacy_ri if ri_name == "legacy" else files / ri_name
    argv = ["print-stats", str(ri_path), *([str(files / tags_name)] if tags_name else []),
            *extra]
    (jax_rc, jax_out, jax_err), (rc, out, err) = both_outputs(capfd, argv)
    assert jax_rc == rc == 0 and out == jax_out and err == jax_err == ""
    totals = [int(x) for x in re.findall(r"^TOTAL [^:]*\(on disk\): (\d+) bytes", out, re.M)]
    assert totals == [ri_path.stat().st_size]
    if tags_name:
        totals = re.findall(r"^TOTAL tag arrays \(compressed\): (\d+) bytes", out, re.M)
        assert [int(x) for x in totals] == [(files / tags_name).stat().st_size]
    assert ("=== Runtime flat tables" in out) == ("--runtime" in extra)


CONVERT_FLAGS = [[], ["--compact"], ["--no-compat"], ["--compact", "--no-compat"],
                 ["--wrapped"], ["--compact", "--no-compat", "--wrapped"]]


@pytest.mark.parametrize("flags", CONVERT_FLAGS, ids=lambda f: "-".join(f) or "defaults")
def test_convert_tags_matches_jax(files, capfd, tmp_path, flags):
    """convert-tags writes the JAX command line's file, byte for byte, under
    each flag, with the same (empty) stdout and exit code; the file loads
    back to the algorithm file's tags where the header is not decoded as
    data (--no-compat)."""
    src = str(files / "synth.tags")
    capfd.readouterr()
    assert jax_cli.main(["convert-tags", src, str(tmp_path / "jax.tags"), *flags]) == 0
    sys.stdout.flush()
    want = capfd.readouterr()
    assert cli.main(["convert-tags", src, str(tmp_path / "port.tags"), *flags]) == 0
    got = capfd.readouterr()
    assert (got.out, got.err) == (want.out, want.err) == ("", "")
    data = (tmp_path / "port.tags").read_bytes()
    assert data == (tmp_path / "jax.tags").read_bytes()
    assert data.startswith(b"PanIdxTg") == ("--wrapped" in flags)
    if flags == ["--compact", "--no-compat"]:
        assert data == (files / "synth_c.tags").read_bytes()
    if "--no-compat" in flags:
        want_tags = port_tags.load_tags_file(files / "synth.tags")
        back = port_tags.load_tags(data, fmt="auto" if "--wrapped" in flags else
                                   "bytecode-compact" if "--compact" in flags else "bytecode")
        np.testing.assert_array_equal(back.pos_enc, want_tags.pos_enc)
        np.testing.assert_array_equal(back.bwt_start, want_tags.bwt_start)


@pytest.mark.parametrize("case", ["one", "several", "unreadable", "missing"])
def test_tags_check_matches_jax(files, capfd, tmp_path, case):
    """tags-check prints the JAX command line's line for each file, on one
    file and on several (algorithm, bytecode, wrapped); a file that does not
    load ends both with the same stderr line and exit code 1, after the
    lines of the files before it."""
    good = [str(files / "synth.tags"), str(files / "synth_c.tags")]
    wrapped = tmp_path / "wrapped.tags"
    assert cli.main(["convert-tags", good[0], str(wrapped), "--wrapped"]) == 0
    bad = tmp_path / "bad.tags"
    bad.write_bytes((files / "synth_c.tags").read_bytes()[:37])
    paths = {"one": good[:1], "several": [*good, str(wrapped)],
             "unreadable": [good[0], str(bad), good[1]],
             "missing": [str(tmp_path / "nowhere" / "missing.tags")]}[case]
    (jax_rc, jax_out, jax_err), (rc, out, err) = both_outputs(capfd, ["tags-check", *paths])
    assert (rc, out) == (jax_rc, jax_out)
    if case in ("one", "several"):
        assert rc == 0 and err == jax_err == ""
        assert out.count(" runs, covers ") == len(paths)
    else:
        assert rc == 1 and last_line(err) == last_line(jax_err)
        assert "FAILED to load" in last_line(err) and "Traceback" not in err
        assert out.count(" runs, covers ") == (1 if case == "unreadable" else 0)


def test_formats_commands_take_no_device_and_no_verify(files, capfd):
    """print-stats, convert-tags, tags-check, extract-text and build-tags
    run on the host, as in the JAX command line: none takes --device (exit
    code 2). tags-check takes --verify-gbz / --verify-rlbwt since the graph
    modules are ported (test_tags_check_verify_matches_jax)."""
    for argv in (["print-stats", str(files / "synth.ri"), "--device", "cpu"],
                 ["convert-tags", "a", "b", "--device", "cpu"],
                 ["tags-check", str(files / "synth.tags"), "--device", "cpu"],
                 ["extract-text", "x.gbz", "--device", "cpu"],
                 ["build-tags", "x.gbz", "x.rl_bwt", "x.tags", "--device", "cpu"]):
        capfd.readouterr()
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        assert "unrecognized arguments" in capfd.readouterr().err


@pytest.mark.parametrize("cmd", ["print-stats", "convert-tags"])
def test_formats_commands_errors_are_panidx_errors(files, capfd, tmp_path, cmd):
    """A missing input and an invalid .ri end print-stats and convert-tags
    with the JAX command line's `panidx: ...` line and exit code 1."""
    gone = str(tmp_path / "nowhere" / "missing")
    bad_ri = tmp_path / "bad.ri"
    bad_ri.write_bytes(b"\0" * 64)
    cases = ([["print-stats", gone], ["print-stats", str(bad_ri)],
              ["print-stats", str(files / "synth.ri"), gone]] if cmd == "print-stats"
             else [["convert-tags", gone, str(tmp_path / "x.tags")]])
    for argv in cases:
        (jax_rc, jax_out, jax_err), (rc, out, err) = both_outputs(capfd, argv)
        assert jax_rc == rc == 1 and out == jax_out
        assert last_line(err) == last_line(jax_err)
        assert last_line(err).startswith("panidx: ") and "Traceback" not in err


# --- the graph commands: extract-text, build-tags, tags-check --verify-gbz,
# merge-tags, on a whole genome of three synthetic chromosomes ----------------

def took_removed(err: str) -> str:
    """stderr without the per-phase `... took x seconds` lines."""
    return "".join(l for l in err.splitlines(True) if not re.search(r" took [\d.]+ seconds", l))


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """The JAX command line's files of a three-chromosome genome: the whole
    GBZ and the component GBZs, their texts and BWTs, the whole genome's
    .ri, and the components' tags in mixed formats (algorithm, compressed
    sdsl, wrapped compressed bytecode) in a directory of their own."""
    from pangenome_index_tpu.formats import tags as jtagfmt

    d = tmp_path_factory.mktemp("torch_graph_cli")
    whole, subs, _ = synth_multi_component_gbz(5000, 3, n_comps=3, site_rate=0.01, seed=19)
    save_gbz(whole, d / "whole.gbz")
    for i, sub in enumerate(subs):
        save_gbz(sub, d / f"c{i}.gbz")
    (d / "comp").mkdir()
    for stem in ("whole", "c0", "c1", "c2"):
        for argv in (["extract-text", f"{stem}.gbz", "-o", f"{stem}.txt"],
                     ["build-bwt", f"{stem}.txt", f"{stem}.rl_bwt"],
                     ["build-tags", f"{stem}.gbz", f"{stem}.rl_bwt", f"{stem}.tags"]):
            assert jax_cli.main([argv[0], *(a if a.startswith("-") else str(d / a)
                                            for a in argv[1:])]) == 0
    assert jax_cli.main(["build-rindex", str(d / "whole.rl_bwt"), "-o", str(d / "whole.ri")]) == 0
    (d / "comp" / "c0.tags").write_bytes((d / "c0.tags").read_bytes())
    (d / "comp" / "c1.tags").write_bytes(jtagfmt.write_compressed_sdsl(
        jtagfmt.load_tags_file(d / "c1.tags")))
    assert jax_cli.main(["convert-tags", str(d / "c2.tags"), str(d / "comp" / "c2.tags"),
                         "--no-compat", "--wrapped"]) == 0
    return d


def both_runs(capfd, argv, port_extra=()):
    """((exit code, stdout, stderr without the seconds lines) of the JAX
    command line, the same of the port's, which also gets port_extra)."""
    capfd.readouterr()
    jax_rc = jax_cli.main(list(argv))
    sys.stdout.flush()
    jax_out = capfd.readouterr()
    port_rc = cli.main([*argv, *port_extra])
    sys.stdout.flush()
    port_out = capfd.readouterr()
    return ((jax_rc, jax_out.out, took_removed(jax_out.err)),
            (port_rc, port_out.out, took_removed(port_out.err)))


@pytest.mark.parametrize("stem", ["whole", "c1"])
@pytest.mark.parametrize("flags", [[], ["--forward-only"]], ids=["both-strands", "forward"])
@pytest.mark.parametrize("to", ["stdout", "file"])
def test_extract_text_matches_jax(genome, capfd, tmp_path, stem, flags, to):
    """extract-text writes the JAX command line's bytes, to stdout (-o -)
    and to a file, of every sequence and of the forward ones."""
    gbz_path = str(genome / f"{stem}.gbz")
    if to == "stdout":
        (jax_rc, jax_out, jax_err), (rc, out, err) = both_runs(
            capfd, ["extract-text", gbz_path, "-o", "-", *flags])
        assert jax_rc == rc == 0 and out == jax_out and err == jax_err == ""
        text = out.encode()
    else:
        for m, name in ((jax_cli, "jax.txt"), (cli, "port.txt")):
            assert m.main(["extract-text", gbz_path, "-o", str(tmp_path / name), *flags]) == 0
        text = (tmp_path / "port.txt").read_bytes()
        assert text == (tmp_path / "jax.txt").read_bytes()
    lines = text.split(b"\n")
    assert lines[-1] == b"" and len(lines) - 1 == (9 if stem == "whole" else 3) * (
        1 if flags else 2)
    if not flags:
        assert text == (genome / f"{stem}.txt").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--stats"], ["--stats", "--k", "15"],
                                   ["--stream-sa", "--sa-window-bytes", "1024"]],
                         ids=["plain", "stats", "stats-k15", "stream-sa"])
def test_build_tags_matches_jax(genome, capfd, tmp_path, flags):
    """build-tags writes the JAX command line's file, with its stdout, exit
    code and stderr (the coverage lines of --stats among it); the file is
    the JAX build of the same inputs."""
    outs = [str(tmp_path / "jax.tags"), str(tmp_path / "port.tags")]
    capfd.readouterr()
    assert jax_cli.main(["build-tags", str(genome / "c0.gbz"), str(genome / "c0.rl_bwt"),
                         outs[0], *flags]) == 0
    want = capfd.readouterr()
    seconds = {}
    assert cli.main(["build-tags", str(genome / "c0.gbz"), str(genome / "c0.rl_bwt"),
                     outs[1], *flags], seconds) == 0
    got = capfd.readouterr()
    assert got.out == want.out == ""
    assert took_removed(got.err) == took_removed(want.err)
    assert ("The fraction of the tag arrays covered" in got.err) == ("--stats" in flags)
    assert (tmp_path / "port.tags").read_bytes() == (tmp_path / "jax.tags").read_bytes() \
        == (genome / "c0.tags").read_bytes()
    assert {"Building the r-index", "Serializing tag runs"} <= set(seconds)


@pytest.mark.parametrize("case", ["ok", "several", "other-graph", "one-flag"])
def test_tags_check_verify_matches_jax(genome, capfd, case):
    """tags-check --verify-gbz --verify-rlbwt prints the JAX command line's
    `verification OK` line for the graph's own tags, `FAILED (k positions
    differ)` and exit code 1 for another graph's; with one of the two flags
    no verification, as in the JAX command line."""
    gbz_path, rl = str(genome / "c1.gbz"), str(genome / "c1.rl_bwt")
    argv = {"ok": ["tags-check", str(genome / "c1.tags"), "--verify-gbz", gbz_path,
                   "--verify-rlbwt", rl],
            "several": ["tags-check", str(genome / "c1.tags"), str(genome / "comp" / "c1.tags"),
                        "--verify-gbz", gbz_path, "--verify-rlbwt", rl],
            "other-graph": ["tags-check", str(genome / "c1.tags"), str(genome / "c2.tags"),
                            "--verify-gbz", gbz_path, "--verify-rlbwt", rl],
            "one-flag": ["tags-check", str(genome / "c2.tags"), "--verify-gbz", gbz_path]}[case]
    (jax_rc, jax_out, jax_err), (rc, out, err) = both_runs(capfd, argv)
    assert (rc, out, err) == (jax_rc, jax_out, jax_err)
    assert rc == (1 if case == "other-graph" else 0)
    assert out.count("verification OK") == {"ok": 1, "several": 2, "other-graph": 1,
                                            "one-flag": 0}[case]
    assert ("positions differ)" in out) == (case == "other-graph")


@pytest.mark.parametrize("engine", [["--engine", "host"], ["--engine", "host", "--window",
                                                             "97", "--chunk-runs", "5"],
                                    ["--engine", "device"]],
                         ids=["host", "host-small-windows", "device"])
def test_merge_tags_matches_jax(genome, capfd, tmp_path, engine):
    """merge-tags on the components' tags in mixed formats writes the JAX
    command line's file (its host engine's, which its device engine's
    equals), with its stdout, exit code and stderr; the port's device
    engine runs the kernel's plain version (--device cpu). From row n_seq
    on the merged positions are the whole genome's direct build."""
    from pangenome_index_tpu.formats import tags as jtagfmt

    outs = [str(tmp_path / "jax.tags"), str(tmp_path / "port.tags")]
    args = [str(genome / "whole.gbz"), str(genome / "whole.ri"), str(genome / "comp")]
    capfd.readouterr()
    assert jax_cli.main(["merge-tags", *args, outs[0], *engine]) == 0
    want = capfd.readouterr()
    seconds = {}
    extra = ["--device", "cpu"] if "device" in engine else []
    assert cli.main(["merge-tags", *args, outs[1], *engine, *extra], seconds) == 0
    got = capfd.readouterr()
    assert got.out == want.out == "" and got.err == want.err
    assert "(sdsl stream)" in got.err and "(bytecode stream)" in got.err
    data = (tmp_path / "port.tags").read_bytes()
    assert data == (tmp_path / "jax.tags").read_bytes()
    assert set(seconds) == ({"load", "route", "rows", "rle", "write"}
                            if "device" in engine else {"load", "merge", "write"})
    merged, direct = jtagfmt.load_tags(data), jtagfmt.load_tags_file(genome / "whole.tags")
    per_pos = np.repeat(merged.pos_enc, merged.run_lengths())
    n_seq = 18
    assert not per_pos[:n_seq].any()
    np.testing.assert_array_equal(per_pos[n_seq:],
                                  np.repeat(direct.pos_enc, direct.run_lengths()))


@pytest.mark.parametrize("cmd", ["extract-text", "build-tags", "tags-check", "merge-tags",
                                 "merge-tags-device"])
def test_graph_commands_missing_gbz_is_panidx_error(genome, capfd, tmp_path, cmd):
    """A missing GBZ ends each graph command with the JAX command line's
    `panidx: ...` line on stderr and exit code 1."""
    gone = str(tmp_path / "nowhere" / "missing.gbz")
    argv, extra = {
        "extract-text": (["extract-text", gone], []),
        "build-tags": (["build-tags", gone, str(genome / "c0.rl_bwt"),
                        str(tmp_path / "x.tags")], []),
        "tags-check": (["tags-check", str(genome / "c0.tags"), "--verify-gbz", gone,
                        "--verify-rlbwt", str(genome / "c0.rl_bwt")], []),
        "merge-tags": (["merge-tags", gone, str(genome / "whole.ri"), str(genome / "comp"),
                        str(tmp_path / "m.tags")], []),
        "merge-tags-device": (["merge-tags", gone, str(genome / "whole.ri"),
                               str(genome / "comp"), str(tmp_path / "m.tags"), "--engine",
                               "device"], ["--device", "cpu"]),
    }[cmd]
    (jax_rc, jax_out, jax_err), (rc, out, err) = both_runs(capfd, argv, extra)
    assert jax_rc == rc == 1 and out == jax_out
    assert last_line(err) == last_line(jax_err)
    assert last_line(err).startswith("panidx: ") and gone in err and "Traceback" not in err
