"""The control: the reference in bfloat16, the precision below the
configurations' float32, put in the program's place must come out as not
correct in every cell (here at the CPU sizes of tests/small_cells.py; the
readings at the cells' own sizes come from `python3 -m portbench.control`
on the card)."""
import pytest
import torch

from portbench.registry import Registry
from portbench.tests.small_cells import small

CELLS = ["stereo1080.stream", "stereo1080.replay4", "rgbd640.integrate", "rgbd640.backlog4"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    reg = Registry()
    cell, cfg = small(reg, name)
    drv = reg.driver(cell["driver"]).Driver(cfg, cell, 3_000_000_019, "cpu")
    drv.finish()
    samples = drv.control(torch.bfloat16)
    limits = cell["limits"]
    assert samples and set(samples[0]) == set(limits)
    over = [k for s in samples for k in limits if not s[k] <= limits[k]]
    assert over, f"the bfloat16 control passed every limit: {samples}"
