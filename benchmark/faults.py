"""Faults planted in the program underneath a run, which the comparison
has to find: the faults that a cell of this benchmark can have (a cell on
one card has no exchange between chips to leave out).

Each planter takes ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or :func:`patched`'s) and replaces one function
of the program with a broken copy.  ``python3 -m benchmark.control
--fault <name>`` reads one on the card at a cell's size.
"""

from __future__ import annotations

import contextlib


def state_unchanged(patch):
    """Every Gauss-Newton step returns the warp it was given."""
    from upsp_tpu_torch.ops import registration

    real = registration._gn_step

    def step(img, tmpl, kshift, warp, rho_prev, valid_shift):
        _, rho, drho = real(img, tmpl, kshift, warp, rho_prev, valid_shift)
        return warp.clone(), rho, drho

    patch(registration, "_gn_step", step)


def _wrap_chunks(patch, alter):
    from upsp_tpu_torch.pipeline import run

    real = run.make_chunk_processor

    def make(*a, **kw):
        fn = real(*a, **kw)

        def process(chunk):
            return alter(*fn(chunk))

        return process

    patch(run, "make_chunk_processor", make)


def half_the_batch(patch):
    """Each chunk's second half of frames left out, the first half's rows
    standing in for them."""
    def alter(sols, teles):
        half = sols.shape[0] // 2
        sols = sols.clone()
        sols[half : 2 * half] = sols[:half]
        return sols, teles

    _wrap_chunks(patch, alter)


def answer_altered(patch):
    """One node of each chunk's first frame off by one 12-bit count."""
    def alter(sols, teles):
        sols = sols.clone()
        sols[0, sols.shape[1] // 2] += 1.0
        return sols, teles

    _wrap_chunks(patch, alter)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch, answer_altered)}


@contextlib.contextmanager
def patched(name: str):
    """The fault ``name`` planted for the body of the ``with``, then taken out."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
