"""The port's LM training step against the JAX package's for the seven
architectures tests/test_torch_lm_train.py leaves out: deepseek-v2-lite
(MLA, the softmax MoE with its load-balance loss), musicgen-medium (audio
frames, cross-attention, the codebook loss), internvl2-2b (the text-only
loss after the vision patches), gemma3-12b (local and global attention),
qwen1.5-32b, granite-20b and nemotron-4-340b: ``loss_fn`` and its
metrics, every float leaf's gradient and one ``make_train_step`` step,
with that file's operands and tolerances."""
import pytest

pytest.importorskip("torch")

from test_torch_lm_train import (  # noqa: E402
    ARCHS as _COVERED, check_grads, check_loss_and_metrics,
    check_train_step,
)
from repro_torch import configs  # noqa: E402

ARCHS = tuple(a for a in configs.ARCHS if a not in _COVERED)


def test_every_architecture_is_covered():
    assert len(ARCHS) == 7 and len(_COVERED) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_the_reference(arch):
    check_loss_and_metrics(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_the_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    check_train_step(arch)
