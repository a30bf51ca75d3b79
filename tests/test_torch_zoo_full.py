"""The full head layouts of the zoo's families against the reference, on
the CPU: zamba2 (six Mamba2 layers, both shared blocks, head dim 80, under
all three ``impl``s), deepseek-v2-lite (all 64 experts, MLA without a query
LoRA) and deepseek-v3 (256 experts, MLA with one), whisper and llava, each
cut as ``tests/test_torch_zoo.py`` says, through the same check as that
file's smoke configs (forward, prefill, every cache leaf and a decode step
at float32 1e-4).  A file of its own so that test workers run it beside the
rest.
"""
import pytest

from test_torch_zoo import CASES, check_family


@pytest.mark.parametrize("name,impl", CASES)
def test_full_layout_matches_reference(name, impl):
    check_family(name, impl, "full")
