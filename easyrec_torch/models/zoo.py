"""Imports every model family, so that MODELS holds every model class.

Counterpart of easyrec_tpu/models/zoo.py: the imports are not wrapped in
try/except, so a broken import fails here rather than as an unknown
model_class later.
"""

from easyrec_torch.models import backbone_model  # noqa: F401
from easyrec_torch.models import match  # noqa: F401
from easyrec_torch.models import match_extra  # noqa: F401
from easyrec_torch.models import multi_task  # noqa: F401
from easyrec_torch.models import rank  # noqa: F401
from easyrec_torch.models import rank_extra  # noqa: F401
