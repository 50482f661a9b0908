"""Shared enums and type aliases for the data pipeline (the port's own
copy of sast_tpu/data/types.py). Batch dicts use these enums' ``value``
strings as keys where applicable."""

from __future__ import annotations

from enum import Enum, auto
from typing import Dict, List, Optional, Tuple


class DataType(Enum):
    EV_REPR = "ev_repr"
    FLOW = "flow"
    IMAGE = "image"
    OBJLABELS = "objlabels"
    OBJLABELS_SEQ = "labels"
    IS_REAL_MASK = "is_real_mask"
    IS_FIRST_SAMPLE = "is_first"
    TOKEN_MASK = "token_mask"


class DatasetType(Enum):
    GEN1 = auto()
    GEN4 = auto()


class DatasetMode(Enum):
    TRAIN = auto()
    VALIDATION = auto()
    TESTING = auto()


class DatasetSamplingMode(Enum):
    RANDOM = "random"
    STREAM = "stream"
    MIXED = "mixed"


class ObjDetOutput(Enum):
    LABELS_PROPH = auto()
    PRED_PROPH = auto()
    EV_REPR = auto()
    SKIP_VIZ = auto()


# type aliases
FeatureMap = "torch.Tensor"
BackboneFeatures = Dict[int, "torch.Tensor"]
LstmState = Tuple["torch.Tensor", "torch.Tensor"]
LstmStates = List[Optional[LstmState]]
