"""The plain reference of the benchmark's steps, written from the step's
definition and independent of the program: it imports nothing of it, and
works out the Slater-Condon elements, the heat-bath tables, the trial
vectors and every compression from the benchmark's integrals.  Its random
numbers are the program's draws: the systematic FRI step's seven uniforms,
and FCIQMC's key tree (``rng.py``, a copy of the program's counter-based
generator).

``REAL`` is the precision of its values: float64, or float32 when the
environment sets ``REFERENCE_PRECISION=float32`` (the control of the
correctness check, which has to fail it).
"""

import os

import torch

REAL = torch.float32 if os.environ.get("REFERENCE_PRECISION") == "float32" else torch.float64
