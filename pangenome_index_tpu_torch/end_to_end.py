"""End-to-end demo: synthetic pangenome graph -> GBZ -> indexes -> serving,
through the package's public functions.

The port's counterpart of examples/end_to_end.py: the same steps, the same
printed lines. The MEMs and the tag positions come from the kernels on the
card (the plain versions with --device cpu); without a card the default
device raises.

    python -m pangenome_index_tpu_torch.end_to_end [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

import pangenome_index_tpu_torch as px
from pangenome_index_tpu_torch.core.gbwt_build import random_pangenome_gbz
from pangenome_index_tpu_torch.core.tagbuild import build_tags
from pangenome_index_tpu_torch.formats.gbz import node_seq
from pangenome_index_tpu_torch.formats.gbz_write import save_gbz
from pangenome_index_tpu_torch.ops.tables import tags_to_device
from pangenome_index_tpu_torch.ops.tagquery import query_tags_batch


def main(device="cuda") -> list[str]:
    """Run the demo on `device`; print its lines and return them. Without a
    card the default device raises (in to_device)."""
    device = torch.device(device)
    lines_out: list[str] = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines_out.append(line)

    rng = np.random.default_rng(0)

    # 1. a variation graph with 3 diploid-ish haplotypes (both strands)
    gbz = random_pangenome_gbz(rng, n_nodes=60, n_paths=3)
    with tempfile.TemporaryDirectory() as d:
        save_gbz(gbz, os.path.join(d, "demo.gbz"))
        say(f"graph: {sum(1 for s in gbz.graph.sequences if s)} nodes, "
            f"{gbz.index.sequences} sequences (GBZ written)")

    # 2. haplotype text + r-index
    lines = [b"".join(node_seq(gbz, n >> 1, bool(n & 1)) for n in gbz.index.extract(i))
             for i in range(gbz.index.sequences)]
    idx = px.build_index(lines)
    say(f"index: BWT size {idx.n}, {idx.n_runs} runs")

    # 3. tag array (BWT position -> graph position)
    tags = build_tags(gbz, idx)
    say(f"tags: {tags.n_runs} runs covering {tags.total} positions")

    # 4. serve: MEMs for reads spliced from two haplotypes, then graph positions
    tables = px.to_device(idx, device)
    tt = tags_to_device(tags, device)
    read = lines[0][:25] + lines[2][10:35]
    mems = px.find_mems(tables, [read], min_len=12, min_occ=1)[0]
    say(f"read of {len(read)} bp -> {len(mems)} MEMs")
    for start, end, bwt_start, size in mems:
        first, last = bwt_start - idx.n_seq, bwt_start + size - 1 - idx.n_seq
        q = query_tags_batch(tt, torch.tensor([first], dtype=tt.bwt_start.dtype, device=device),
                             torch.tensor([last], dtype=tt.bwt_start.dtype, device=device))
        hits = q.positions[0][: int(q.n_unique[0])].cpu().numpy()
        spots = [(int(h) >> 11, bool((int(h) >> 10) & 1), int(h) & 0x3FF) for h in hits]
        say(f"  MEM [{start},{end}) x{size}: graph positions {spots[:4]}"
            + (" ..." if len(spots) > 4 else ""))
    return lines_out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tables and kernels (default cuda)")
    main(ap.parse_args().device)
