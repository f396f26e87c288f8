"""The program's host syncs (``utils.trace.host_syncs``: calls inside its
spans that make the host wait for the card) over the slice's requests."""

from port_bench.spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx)
