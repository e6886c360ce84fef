"""The port's LightReSeg (``models/lightreseg.py``) against the JAX
package's on the same numpy-seeded inputs and weights, carried by
``utils/convert.layer_map``, at 32x32 (a 2x2 grid of 4 tokens), batch 2,
with every channel attention's ``gamma`` drawn non-zero (zero at init, it
would hide them), in eval and train mode at 1e-4 scale-relative with the
running statistics after the train call; the position embedding's slice
(a 48x48 input: 9 tokens, ``pos_embedding[:, :10]``); the raise above 1444
tokens; the parameter tree at the default width."""

import functools

import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    lightreseg as jlight,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    lightreseg,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from test_torch_common import (
    check_zoo_forward,
    default_tree_matches,
    jax_eval_train,
    jax_variables,
    load_jax,
    nchw,
    normal_images,
    scale_rel,
)

NC, TOL = 7, 1e-4


@functools.lru_cache(maxsize=None)
def _jax_case(hw):
    """(input, variables, eval output, train output, batch_stats)."""
    jm = jlight.LightReSeg(num_classes=NC)
    x = normal_images(1, 2, hw)
    v = jax_variables(jm, x)
    return (x, v) + tuple(jax_eval_train(jm, x, v))


def _port():
    return lightreseg.LightReSeg(1, NC, generator=torch.Generator())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lightreseg_forward(train):
    x, v, want_eval, want_train, stats = _jax_case(32)
    gammas = [t for k, t in v["params"]["ExpansiveBlock_0"][
        "AttentionModule_0"].items() if k.startswith("Channel")]
    assert all(float(g["gamma"][0]) > 0.4 for g in gammas)
    check_zoo_forward(_port(), v, x, want_train if train else want_eval,
                      stats, train, TOL)


def test_position_slice():
    """A 48x48 input gives a 3x3 grid: 9 tokens take the cls position and
    the first 9 others. Changing the positions past them changes
    nothing; the eval output matches JAX's."""
    x, v, want_eval, _, _ = _jax_case(48)
    tm = load_jax(_port(), v).eval()
    with torch.no_grad():
        got = tm(nchw(x))
        assert scale_rel(got, want_eval) <= TOL
        tm.pos_embedding[:, 10:] += 100.0
        assert torch.equal(tm(nchw(x)), got)
        tm.pos_embedding[:, 9] += 1.0
        assert not torch.equal(tm(nchw(x)), got)


def test_more_tokens_than_positions_raise():
    """39x39 tokens (1521 > 1444) raise; 38x38 (1444) run. Checked with
    ``num_positions`` cut to 10 (9 tokens run, 16 raise) at a small size,
    and the default's bound read from the module."""
    tm = lightreseg.LightReSeg(1, NC, num_positions=10,
                               generator=torch.Generator()).eval()
    with torch.no_grad():
        tm(torch.zeros(1, 1, 48, 48))  # 3x3 = 9 tokens
        with pytest.raises(ValueError, match="16 tokens"):
            tm(torch.zeros(1, 1, 64, 64))
    assert get_model("lightreseg").pos_embedding.shape[1] - 1 == 1444


def test_default_width_parameters():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model("lightreseg"),
                         get_model("lightreseg"), 64)
