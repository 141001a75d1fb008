"""Distribution (``vispeech_tpu/parallel``): the trainer's mesh of a data
axis and a model axis (``mesh.py``), the parameters the model axis shards
(``sharding.py``) and its collectives (``tensor.py``); for inference,
context parallelism (``context.py``: ring attention and the overlap-save
vocoder) and the two-stage pipeline (``pipeline.py``), whose neighbour
hops are ``p2p.py``'s."""

from vispeech_tpu_torch.parallel.context import (
    GENERATOR_HALO_FRAMES,
    context_groups,
    make_generator_context_parallel,
    make_ring_attention,
    ring_relative_self_attention,
)
from vispeech_tpu_torch.parallel.mesh import Mesh, make_mesh
from vispeech_tpu_torch.parallel.p2p import shift
from vispeech_tpu_torch.parallel.pipeline import N_STAGES, make_synthesizer_pipeline
from vispeech_tpu_torch.parallel.tensor import ModelShard

__all__ = ["GENERATOR_HALO_FRAMES", "Mesh", "ModelShard", "N_STAGES", "context_groups",
           "make_generator_context_parallel", "make_mesh", "make_ring_attention",
           "make_synthesizer_pipeline", "ring_relative_self_attention", "shift"]
