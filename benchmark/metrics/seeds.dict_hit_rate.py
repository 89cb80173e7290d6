"""The share of the reads' valid windows that the long-seed dictionary holds
(serve.Batch.dict_hit_rate of the pool's one prepare)."""

UNIT = "%"
MOVES = "reads_per_s"
SOURCE = "program_counter"


def read(r):
    return 100.0 * r["dict_hit_rate"]
