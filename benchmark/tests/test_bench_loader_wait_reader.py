"""The reader of the training loop's waits on the loader's producer
process, on hand-made contexts: spans in and out of the window, a program
whose batches carry their parts' spans but no ``loader.wait``, and nothing
read without a trace."""

import pytest

from benchmark.run import metric_reader

WIN = (1_000, 100_000)


def _batches(spans):
    return {"events": {"spans": sorted(spans), "device": []}, "win": WIN,
            "steps": [{"load_s": 0.0}] * 3}


def _in_process_batches():
    out = []
    for t in (2_000, 30_000, 60_000):
        out += [(t, t + 20_000, "loader.batch"),
                (t + 100, t + 1_100, "loader.read"),
                (t + 4_000, t + 4_500, "loader.augment"),
                (t + 5_000, t + 5_250, "loader.offsets"),
                (t + 10_000, t + 10_400, "loader.collate"),
                (t + 15_000, t + 19_000, "step.forward")]
    return out


def test_loader_wait_reader():
    read = metric_reader("loader_wait_ms.train")
    spans = [(2_000, 3_000, "loader.wait"), (30_000, 30_500, "loader.wait"),
             (60_000, 64_500, "loader.wait"),              # 6,000 ns, 3 in
             (500, 1_500, "loader.wait"),                  # starts before
             (99_000, 100_500, "loader.wait"),             # ends after
             (4_000, 20_000, "step.forward")]
    assert read(_batches(spans)) == pytest.approx(6_000 / 1e6 / 3)
    assert read(_batches([(4_000, 20_000, "step.forward")])) is None
    # a program without a producer: its batches' spans, no loader.wait
    assert read(_batches(_in_process_batches())) is None
    assert read({"steps": [{"load_s": 0.1}], "win": WIN}) is None
