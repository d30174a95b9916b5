"""Device dtype policy: the representation of every ``DataType`` on the card.

The same policy as the reference's ``tpu/dtypes.py``, so wire batches, state
leaves and outputs are bit-comparable across the two packages:

- ``DOUBLE``/``FLOAT`` → float32;
- ``INT`` and string dictionary codes → int32;
- ``LONG`` and event timestamps → int64;
- ``BOOL`` → bool.

``TORCH_HOST`` is the columnar host tier's policy (``gpu/host_exec.py``,
the reference's ``NP_HOST`` in ``tpu/backend.py``): full width like the
scalar interpreter (Java long/double), so that tier matches the
interpreter exactly; ``NP_HOST`` is the same table for the numpy columns
its stager builds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..query_api.definition import DataType

# device (torch) representation per declared attribute type
TORCH = {
    DataType.STRING: torch.int32,   # dictionary codes
    DataType.INT: torch.int32,
    DataType.LONG: torch.int64,
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float32,
    DataType.BOOL: torch.bool,
}

# host staging (numpy) representation — mirrors TORCH
NP = {
    DataType.STRING: np.int32,
    DataType.INT: np.int32,
    DataType.LONG: np.int64,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float32,
    DataType.BOOL: np.bool_,
}

# columnar host tier (torch on the CPU) per declared attribute type
TORCH_HOST = {
    DataType.STRING: torch.int32,   # dictionary codes
    DataType.INT: torch.int64,
    DataType.LONG: torch.int64,
    DataType.FLOAT: torch.float64,
    DataType.DOUBLE: torch.float64,
    DataType.BOOL: torch.bool,
}

# the host tier's staging (numpy) representation — mirrors TORCH_HOST
NP_HOST = {
    DataType.STRING: np.int32,
    DataType.INT: np.int64,
    DataType.LONG: np.int64,
    DataType.FLOAT: np.float64,
    DataType.DOUBLE: np.float64,
    DataType.BOOL: np.bool_,
}

TS = torch.int64            # event-time representation
NP_TS = np.int64
