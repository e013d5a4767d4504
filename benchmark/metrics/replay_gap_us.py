"""Device us from a step's end stamp to the next replay's first stamp
within a chunk, the mean over the span run's steps
(``benchmark/spans.py``): the card's wait between two graph replays."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.replay_gaps_us().size:
        return None
    return float(s.replay_gaps_us().mean())
