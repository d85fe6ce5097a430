"""Padded frames over the bucket frames of the window's engine calls
(``BucketSpec.pick`` on each batch), in %: an exact count."""

from port_bench.metrics import shares


def read(run):
    return shares.pad(run)
