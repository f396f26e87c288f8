"""Milliseconds a request of device idle ended by an operation launched
inside ``gfs.posterior.predict_f`` (or a span nested in it), on the
launching thread: the card waiting on the request's host work
(``spans.idle_ms``)."""

from port_bench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("gfs.posterior.predict_f",))
