"""The control: the reference at float8 weights in the program's place
reads far above what the program reads, and the harness's own verdict
on it comes out not correct, at a size a test run holds (the chip's
readings, at the cells' sizes, are in PERF.md)."""
import pytest
import torch

from kbench import harness
from kbench.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread while a window runs, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
def test_control_reads_above_the_program(tmp_path, family):
    root = tiny.make_root(tmp_path, (family,), limit=0.01)
    bench = harness.Bench(root, f"tiny-{family}.mix", "cpu")
    served, control = [], []
    for i, seed in enumerate((21, 2 ** 31 + 22)):
        bench.prepare(seed, warm=(i == 0))
        out = bench.run(seed, 1.0, False)
        v = harness.correctness(bench, out, seed, control=True)
        served += v["gaps"]["served"]
        control += v["gaps"]["control"]
        assert v["correct"], v["checks"]
        assert not v["control_correct"], v["control_checks"]
    assert max(served) <= 0.01
    assert max(control) > 0.01
    assert max(control) >= 3 * max(served)
