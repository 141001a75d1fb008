"""Piecewise monotone rational-quadratic spline with linear tails
(``vispeech_tpu/ops/spline.py``): the transform of Durkan et al., "Neural
Spline Flows" (2019), forward, inverse and log|det J|, with no data-dependent
control flow.  Minimum bin width and height 1e-3, minimum derivative 1e-3.

As in the JAX package: the bin of an input is ``sum(edges <= x) − 1``
clamped to [0, K−1] (no ``eps`` added to the last edge), and inputs outside
[−tail_bound, tail_bound] are clamped into it for the spline's arithmetic,
then pass through unchanged with a log-det of 0.  An input at exactly
±tail_bound is inside.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted_lastdim(bins: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the bin holding x: sum(bins <= x) − 1, clamped to [0, K−1]."""
    idx = torch.sum(bins <= x[..., None], dim=-1) - 1
    return torch.clamp(idx, 0, bins.shape[-1] - 2)


def _knots(unnormalized: torch.Tensor, lo: float, hi: float, min_bin: float):
    """Softmax bin sizes → (knot positions [..., K+1], bin sizes [..., K]),
    the end knots set exactly to ``lo`` and ``hi``."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs [...], widths / heights [..., K], derivatives [..., K+1] →
    (outputs, logabsdet)."""
    cumwidths, widths = _knots(unnormalized_widths, left, right, min_bin_width)
    cumheights, heights = _knots(unnormalized_heights, bottom, top, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted_lastdim(cumheights if inverse else cumwidths, inputs)[..., None]

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    input_heights = take(heights)
    input_delta = take(heights / widths)
    input_derivatives = take(derivatives)
    input_derivatives_p1 = take(derivatives[..., 1:])
    slope_sum = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        shifted = inputs - input_cumheights
        a = shifted * slope_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - shifted * slope_sum
        c = -input_delta * shifted
        discriminant = b * b - 4 * a * c
        # clamp: numerical safety, mathematically discriminant >= 0
        root = 2 * c / (-b - torch.sqrt(torch.clamp(discriminant, min=0.0)))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + slope_sum * theta_one_minus_theta
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_p1 * root ** 2
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2)
        logabsdet = -(torch.log(derivative_numerator) - 2 * torch.log(denominator))
        return outputs, logabsdet

    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta ** 2
                                 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + slope_sum * theta_one_minus_theta
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_p1 * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear tails outside [−tail_bound, tail_bound]: identity, log-det 0.
    ``unnormalized_derivatives`` [..., K−1]: the two end knots' derivatives
    are padded to 1."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    # clamp out-of-interval inputs into range to keep the spline's math
    # finite, then select the identity for them
    safe_inputs = torch.clamp(inputs, -tail_bound, tail_bound)
    outputs_in, logabsdet_in = rational_quadratic_spline(
        safe_inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, left=-tail_bound, right=tail_bound, bottom=-tail_bound,
        top=tail_bound, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    outputs = torch.where(inside, outputs_in, inputs)
    logabsdet = torch.where(inside, logabsdet_in, torch.zeros_like(logabsdet_in))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
    inverse=False, tails=None, tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT, min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """The spline on [0, 1] (``tails`` None) or with linear tails."""
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
            inverse=inverse, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
            min_derivative=min_derivative)
    if tails != "linear":
        raise ValueError(f"unsupported tails: {tails}")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, tail_bound=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
