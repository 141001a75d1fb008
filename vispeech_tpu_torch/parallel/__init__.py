"""Distribution (``vispeech_tpu/parallel``): the trainer's data axis
(``mesh.py``).  The model axis, ``context.py`` and ``pipeline.py`` are
``ROADMAP.md`` queue 1 items 7b, 7c and 7d."""

from vispeech_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
