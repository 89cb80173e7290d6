"""`correct` comes out false for the control (the reference with one of the
configuration's guarantees broken, in the program's place) and for a run
whose timed path is broken underneath: a call that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced, tag counts that ignore the tag array. (The cells run on one card: there is no exchange between chips to
leave out.) On the CPU, at a size a test run holds; the same control runs on
the card with `--control` at the cells' own sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run, tiny


#: many haplotypes with many variants, reads with many errors: a read's error
#: that is another haplotype's allele starts a MEM that overlaps the last,
#: which only step 3 finds; a repeat family over a third of the base, so
#: that MEMs occur at several loci and their intervals hold several tags
VARIED = {"haplotypes": 8, "snp_rate": 0.05,
          "repeats": {"share": 0.3, "length": 60, "families": 1, "divergence": 0.02}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"), config=VARIED,
                          mix={"error_rate": 0.05})


def _run(root, tmp_path, **kw):
    line, _ = run.run_cell(tiny.TINY_CELL, 31, 3.0, False, device="cpu", root=root,
                           work_dir=tmp_path, **kw)
    return line


def test_sound_run_is_correct(root, tmp_path):
    assert _run(root, tmp_path)["correct"]


def test_skip_rescan_control_is_not_correct(tmp_path):
    # one batch of 512 reads, all checked in the window's first call
    root = tiny.make_root(tmp_path / "checkout", config=VARIED,
                          mix={"error_rate": 0.05, "reads_per_call": 512, "pool_batches": 1})
    line, _ = run.run_cell(tiny.TINY_CELL, 31, 0.1, False, device="cpu", root=root,
                           work_dir=tmp_path, control="skip_rescan")
    assert not line["correct"] and line["compared"]["mems_wrong"]["value"] > 0


def test_int32_control_breaks_positions_past_2_31():
    ans = {"count": np.array([1, 1]), "nu": np.zeros((2, 1)), "ov": np.zeros((2, 1), bool),
           "slots": np.array([[[0, 20, 2**31 + 5, 3]], [[0, 20, 7, 3]]], np.int64)}
    found = run.compare(run._int32(ans), ans, 1)
    assert found == {"count_wrong": 0, "mems_wrong": 1, "tags_wrong": 0}


def test_a_control_the_configuration_lacks_is_refused(root, tmp_path):
    cfg = root / "benchmark" / "configs" / "tiny.json"
    with pytest.raises(ValueError):
        run.run_cell(tiny.TINY_CELL, 1, 0.1, False, device="cpu", root=root,
                     work_dir=tmp_path, control="no_such")
    assert cfg.exists()


def _stale(monkeypatch):
    from pangenome_index_tpu_torch import serve

    real, first = serve.run, []

    def run_unchanged(batch, **kw):
        if not first:
            first.append(real(batch, **kw))
        return first[0]
    monkeypatch.setattr(serve, "run", run_unchanged)


def _half(monkeypatch):
    from pangenome_index_tpu_torch import serve

    real = serve.find_mems

    def half_batch(t, codes, lengths, *a, **kw):
        h = codes.shape[0] // 2
        part = {k: (v[:h] if k in run._PER_READ else v)
                for k, v in kw.items()}
        res = real(t, codes[:h], lengths[:h], *a, **part)
        return type(res)(*(torch.cat((x, torch.zeros_like(x[: codes.shape[0] - h])))
                           for x in res))
    monkeypatch.setattr(serve, "find_mems", half_batch)


def _altered(monkeypatch):
    from pangenome_index_tpu_torch import serve

    real = serve.find_mems

    def altered(*a, **kw):
        res = real(*a, **kw)
        r = int(torch.nonzero(res.count > 0)[0, 0])
        res.bwt_start[r, 0] += 1
        return res
    monkeypatch.setattr(serve, "find_mems", altered)


def _constant_tags(monkeypatch):
    from pangenome_index_tpu_torch import serve

    def one_tag(tag_tables, bwt_start, size, count, capacity):
        keep = (torch.arange(bwt_start.shape[1], device=count.device)[None, :]
                < count.clamp(max=bwt_start.shape[1])[:, None])
        return keep.to(torch.int32), torch.zeros_like(keep)
    monkeypatch.setattr(serve, "query_mem_tags", one_tag)


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _constant_tags],
                         ids=["state_unchanged", "half_batch", "answer_altered",
                              "tags_constant"])
def test_a_broken_timed_path_is_not_correct(root, tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(root, tmp_path)
    assert not line["correct"]
    assert sum(v["value"] for v in line["compared"].values()) > 0
    if fault is _constant_tags:
        assert line["compared"]["tags_wrong"]["value"] > 0

