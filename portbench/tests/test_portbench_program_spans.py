"""The program's spans and set-up counters in each cell's traced run on the
card (marked ``cuda``; each skips without one).

Run on the card from the root of the repository:
``python -m pytest portbench/tests -q -m cuda``."""

import pytest
import torch

from portbench.harness import runner

SMALL = {"num_leaves": 4096, "batch": 256, "check_jobs": 2, "trace_jobs": 4}
CELLS = ["sha256_tree.commit", "poseidon_tree.commit", "poseidon_tree.paths", "sha256_tree.paths"]
# rows a job hands to the kernels at SMALL: every leaf and node of the tree
# (2n - 1), or the batch at each of the tree's 13 levels with a hash
KERNEL_ROWS = {"commit": 2 * 4096 - 1, "paths": 256 * 13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(cuda, cell):
    from crypto_primitives_tpu_torch.utils import profiling

    result, _ = runner.run(cell, 2**31 + 79, 0.3, True, device=cuda, scale=SMALL)
    assert result["correct"], result["checks"]
    traffic = cell.split(".")[1]
    metrics = result["metrics"]
    for name in (f"tree_self_ms.{traffic}", f"kernel_host_us.{traffic}", f"kernel_rows.{traffic}",
                 "setup_program_s"):
        assert name in metrics, sorted(metrics)
    assert metrics[f"kernel_rows.{traffic}"]["value"] == KERNEL_ROWS[traffic]
    assert metrics[f"tree_self_ms.{traffic}"]["value"] > 0 and metrics[f"kernel_host_us.{traffic}"]["value"] > 0
    assert metrics["setup_program_s"]["value"] >= 0
    kernel = "k1_roofline" if cell.startswith("poseidon") else "k3_roofline"
    assert f"{kernel}.{traffic}" in metrics

    span_names = {s.name for s in profiling.spans()}
    assert {"tree.hash_level", "kernel.k1" if cell.startswith("poseidon") else "kernel.k3"} <= span_names
    ops = [name for name, _ in result["breakdown"]["device_ops"]]
    assert ops and not [op for op in ops if op in span_names or op.split(".")[0] in ("tree", "kernel")], ops
    if cell.startswith("sha256"):  # host-bound: the device waits inside the tree layer's own spans
        gaps = [label.split(" ")[0] for label, _ in result["breakdown"]["idle_gaps"]]
        assert set(gaps) & (span_names - {"tree.build_tree", "tree.verify_paths"}), gaps
