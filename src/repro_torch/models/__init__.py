"""The LM zoo, the dense decoder family: port of ``src/repro/models``.

``config.py`` (``ModelConfig``), ``layers.py``, ``attention.py`` (GQA),
``transformer.py`` (dense and embedding-input decoders), ``registry.py``
(``get_model``, ``input_specs``, ``reduced_config``) and ``convert.py``
(params to and from the reference, bitwise). MoE, MLA, SSM, hybrid and
encoder-decoder wait for ROADMAP.md Queue 1 #14b.
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
