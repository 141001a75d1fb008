"""Distribution (``vispeech_tpu/parallel``): the trainer's mesh of a data
axis and a model axis (``mesh.py``), the parameters the model axis shards
(``sharding.py``) and its collectives (``tensor.py``).  ``context.py`` and
``pipeline.py`` are ``ROADMAP.md`` queue 1 items 7c and 7d."""

from vispeech_tpu_torch.parallel.mesh import Mesh, make_mesh
from vispeech_tpu_torch.parallel.tensor import ModelShard

__all__ = ["Mesh", "ModelShard", "make_mesh"]
