r"""The host's synchronising calls a sampler step (`harness.spans.SYNCS`)
inside the traced trajectory's `azula.sample.step` spans, over the count
of those spans: exact, so that a copy or a read that waits for the card
shows as a step of at least 1/steps. The count holds the harness's own
copy of the checked positions to the card, in the first network call of
each trajectory: 1/steps of the reading."""

from __future__ import annotations

from harness import spans


def read(trace, cell) -> float | None:
    counts = spans.step_syncs(trace)
    if counts is None:
        return None
    return sum(counts) / len(counts)
