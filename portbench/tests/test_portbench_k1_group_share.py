"""``k1_group_share`` on hand-made traces, on the CPU."""

import pytest

from portbench.harness import loader
from portbench.harness.runner import RunData
from portbench.harness.trace import Trace

ONE_THREAD = "void (anonymous namespace)::permute_kernel<8, 3, 3>(unsigned int const*, unsigned int*, long long)"
GROUPS = "void (anonymous namespace)::permute_kernel_group<8, 3, 4>(unsigned int const*, unsigned int*, long long)"


def _read(device_ops):
    trace = None if device_ops is None else Trace(window_s=1.0, busy_s=0.5, device_ops=device_ops, idle={})
    run = RunData(unit="proofs", units_per_job=1, setup_s=0.0, jobs=1, window_s=1.0, latencies=[1.0], spans={},
                  launches={}, trace=trace)
    return loader.module("metrics", "k1_group_share").read(run)


@pytest.mark.parametrize("device_ops, share", [
    (None, None),  # no trace
    ({ONE_THREAD: 0.4, "sha256_compress_kernel": 0.1}, 0.0),  # K1, no group op
    ({"sha256_compress_kernel": 0.1}, 0.0),  # no K1 at all
    ({GROUPS: 0.3}, 100.0),
    ({GROUPS: 0.1, ONE_THREAD: 0.3, "Memcpy DtoD": 0.2}, 25.0),
])
def test_share_of_k1_in_groups(device_ops, share):
    got = _read(device_ops)
    assert got == (None if share is None else pytest.approx(share))
