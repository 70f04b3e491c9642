"""Where a max-pooling window's gradient goes when its maximum is tied
(ROADMAP C10): the port's `SubsamplingLayer` routes it as the JAX
package's does (`lax.reduce_window` max, whose gradient is XLA's
select-and-scatter), to the first of the tied elements in row-major
window order, and on the card as on the CPU.

Inputs take the values 0, 1 and 2 only, with whole windows of equal
values, so that most windows hold an exact tie; the upstream gradients
are small integers, so every sum is exact and the gradients are compared
bit for bit. The card cases import only torch:
    python -m pytest --noconftest -q -m cuda tests/test_torch_maxpool_ties.py
and skip where there is no card."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer

CASES = {
    "lenet_2x2_s2": dict(kernel=(2, 2), stride=(2, 2)),
    "overlap_3x3_s2": dict(kernel=(3, 3), stride=(2, 2)),
    "same_3x3_s1": dict(kernel=(3, 3), stride=(1, 1),
                        convolution_mode="same"),
}


def _inputs(dtype, seed=0):
    """x [2, 9, 9, 3] over {0, 1, 2} with tied windows, and integer
    upstream gradients for the layer's output."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (2, 9, 9, 3)).astype(dtype)
    x[0, :4, :4, 0] = 1.0            # whole windows of one value
    x[1, :, :, 2] = 2.0              # a whole channel of one value
    return x


def _port_grad(case, x, g, device="cpu"):
    xt = torch.tensor(x, device=device, requires_grad=True)
    y, _ = SubsamplingLayer(**case).apply({}, xt)
    (y * torch.tensor(g, device=device)).sum().backward()
    return y.detach().cpu().numpy(), xt.grad.cpu().numpy()


def _upstream(case, x, seed=1):
    y, _ = SubsamplingLayer(**case).apply({}, torch.tensor(x))
    return np.random.default_rng(seed).integers(1, 5, y.shape).astype(
        x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASES))
def test_tied_windows_route_the_gradient_as_jax(name, dtype):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JaxPool

    case = CASES[name]
    x = _inputs(dtype)
    g = _upstream(case, x)
    y, grad = _port_grad(case, x, g)

    def loss(v):
        out, _ = JaxPool(**case).apply({}, v)
        return jnp.sum(out * g), out

    (_, jy), jgrad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_array_equal(grad, np.asarray(jgrad))
    assert grad.dtype == np.asarray(jgrad).dtype


def test_a_tied_window_routes_to_its_first_element():
    """LeNet's 2x2 pool: a window of four equal values sends its whole
    gradient to the top-left element (the first in row-major order)."""
    case = CASES["lenet_2x2_s2"]
    x = _inputs("float32")
    g = _upstream(case, x)
    _, grad = _port_grad(case, x, g)
    assert grad[0, 0, 0, 0] == g[0, 0, 0, 0]
    assert (grad[0, 0, 1, 0], grad[0, 1, 0, 0], grad[0, 1, 1, 0]) == (0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASES))
def test_tied_windows_route_on_the_card_as_on_the_cpu(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = CASES[name]
    x = _inputs(dtype)
    g = _upstream(case, x)
    y_cpu, grad_cpu = _port_grad(case, x, g)
    y_card, grad_card = _port_grad(case, x, g, device="cuda")
    np.testing.assert_array_equal(y_card, y_cpu)
    np.testing.assert_array_equal(grad_card, grad_cpu)
