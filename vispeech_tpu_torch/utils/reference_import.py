"""The reference's generator checkpoints (``G_*.pth``) as the port's state
dict (the port's counterpart of ``vispeech_tpu/utils/reference_import.py``).

The port keeps the reference's ``SynthesizerTrn`` key names and layouts
(weight-norm ``weight_g`` / ``weight_v``), so no tensor is renamed or
transposed: the ``model`` entry of the saved dict loses the ``module.``
prefix a DDP run saves it with, and the reference's dead weights, which no
forward reads and the port does not define, are dropped.  Any other key
that the port does not have, and any port key left empty, makes the strict
``load_state_dict`` that follows raise.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# key prefixes of weights the reference defines but never uses (its
# models.py:166 enc_p.proj, :456 frame_prior_net.emb, and the energy
# predictor's unused projection)
DEAD_REFERENCE_PREFIXES = (
    "enc_p.proj.",
    "frame_prior_net.emb.",
    "energy_predictor.predictor.proj.",
)


def strip_ddp_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Remove the ``module.`` prefix of a state dict saved from a DDP model."""
    if any(k.startswith("module.") for k in sd):
        return {(k[len("module."):] if k.startswith("module.") else k): v
                for k, v in sd.items()}
    return dict(sd)


def reference_state_dict(ckpt: Mapping) -> Dict[str, torch.Tensor]:
    """A loaded ``G_*.pth`` (the dict with a ``model`` entry, or the bare
    state dict) → the port's generator state dict."""
    sd = ckpt["model"] if "model" in ckpt else ckpt
    return {k: v for k, v in strip_ddp_prefix(sd).items()
            if not k.startswith(DEAD_REFERENCE_PREFIXES)}
