"""``repro_torch.launch.serve`` against the JAX package's launcher: the
same flags, queries and tick log (ipt a request, invocations, drift), on
the CPU (``--device cpu``), for both datasets.  The reference's logger
does not propagate (``repro.utils.logging``), so its lines are read with a
handler on ``repro.launch.serve`` itself; the port's the same way."""
import argparse
import logging
import sys

import pytest
import torch

torch.set_num_threads(1)

from repro.launch import serve as r_serve

from repro_torch.launch import serve


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _log_of(name, run):
    logger, handler = logging.getLogger(name), _Lines()
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        out = run()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.lines, out


# n = 2,000 and 4 ticks; and the defaults (N = 8,000, 10 ticks of 100),
# where musicbrainz's MQ trie has a depth of two nodes of one label, whose
# edge masses must follow the reference's fused multiply-adds.  Both
# packages number the trie by the process's string hash, so the ticks
# differ from one hash seed to another, alike in both
@pytest.mark.parametrize("dataset,size", [
    ("provgen", ["--n", "2000", "--ticks", "4"]),
    ("musicbrainz", ["--n", "2000", "--ticks", "4"]),
    ("provgen", []), ("musicbrainz", [])], ids=["provgen", "musicbrainz",
                                                "provgen-defaults", "musicbrainz-defaults"])
def test_serve_tick_log_equals_reference(dataset, size, monkeypatch):
    argv = ["--dataset", dataset] + size
    ticks = 4 if size else 10
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    want, _ = _log_of("repro.launch.serve", r_serve.main)
    got, records = _log_of("repro_torch.launch.serve",
                           lambda: serve.main(argv + ["--device", "cpu"]))
    assert len(want) == ticks + 1 and got == want
    assert records[-1]["invocations"] >= 1
    assert [r["tick"] for r in records] == list(range(ticks))
    for r, line in zip(records, got):
        assert line == (f"tick {r['tick']}: ipt/request={r['ipt_per_request']:.2f} "
                        f"invocations={r['invocations']} drift={r['drift']:.3f}")


def test_serve_defaults_and_queries(monkeypatch):
    """The reference's defaults (N = 8,000, k = 8, 10 ticks of 100) and
    queries, and the card as the default device."""
    assert serve.QUERIES == r_serve.QUERIES
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def stop_after_parse(self, argv=None, namespace=None):
        seen.update(vars(parse(self, argv, namespace)))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop_after_parse)
    with pytest.raises(SystemExit):
        serve.main([])
    assert seen == {"dataset": "provgen", "n": 8000, "k": 8, "ticks": 10, "batch": 100,
                    "device": "cuda"}
