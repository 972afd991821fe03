"""The program's spans in the benchmark's trace (benchlib/trace.py): a
span is a host range only. On the card (`card` marker; skips without
one), a span around kernel launches adds no device event, so it reads as
no device time, and an idle gap inside it carries its name.

    python -m pytest -q -p no:cacheprovider -n 0 port_bench/tests/test_pb_span_trace.py
"""

import time

import pytest

from benchlib.trace import Trace


@pytest.mark.card
def test_a_span_is_no_device_time_and_names_the_gaps_inside_it(card):
    import torch

    from medgp_tpu_torch.utils import metrics

    x = torch.ones(1 << 20, device=card)
    torch.cuda.synchronize()
    with Trace() as tr:
        with tr.window():
            with metrics.span("medgp.test.outer"):
                for _ in range(20):
                    x = x * 1.0001
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    while time.perf_counter() - t0 < 0.005:  # host work, device idle
                        pass
            torch.cuda.synchronize()
    red = tr.readings()
    assert not [n for n, _ in red["device_ops"] if n.startswith("medgp.")], red["device_ops"]
    assert red["busy_s"] < 0.5 * red["window_s"], red
    assert red["idle_gaps"][0][0] == "medgp.test.outer", red["idle_gaps"]
