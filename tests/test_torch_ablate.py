"""The ablation tools' variants still name text of the kernel sources they
edit (``vispeech_tpu_torch/tools/ablate_*.py``).

Each variant is a list of (old, new) replacements applied to a copy of a
``csrc/*.cu`` file on the card; a replacement whose old text the source no
longer has would fail there, after the build.  This holds them to the
sources here, on the CPU.
"""

import importlib

import pytest

from vispeech_tpu_torch.ops.kernels import _build

TOOLS = {"ablate_wn_stack": "wn_stack", "ablate_mrf_stage": "mrf_stage",
         "ablate_mrf_stage_folded": "mrf_stage_folded",
         "ablate_wn_stack_train": "wn_stack_train",
         "ablate_rel_attention_train": "rel_attention_train"}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_variants_match_their_source(tool):
    module = importlib.import_module(f"vispeech_tpu_torch.tools.{tool}")
    src = (_build.CSRC / f"{TOOLS[tool]}.cu").read_text()
    assert module.VARIANTS["full"] == []
    for name, subs in module.VARIANTS.items():
        text = src
        for old, new in subs:
            assert old in text, f"{tool} variant '{name}': {old[:60]!r}"
            text = text.replace(old, new)
        assert (text != src) == bool(subs), f"{tool} variant '{name}' changes nothing"
