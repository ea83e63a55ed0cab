"""The plain step of one scene of the beams pin-speed sweep: the published
beams scene (reference/physics.py ``BeamsReference``) with its pins pulled
at `speed` m/s where beams.cpp pulls at 1 m/s, the initial placement
included (after k stretches the pins sit speed * k * dt from rest). A
scene of the sweep is independent of the others, so there is no ensemble
here: the check runs each scene it compares by itself. It imports nothing
of the port and takes nothing that the port has made.

TF32 matmuls and convolutions are switched off for the process when a
reference is made (the scene is float64, which TF32 never touches; a
float32 control must not run in TF32 either).
"""

from __future__ import annotations

import numpy as np
import torch

from .physics import BeamsReference


class SweepSceneReference(BeamsReference):
    """One scene of the sweep: its pin speed, frames and state."""

    def __init__(self, cfg, speed, device, dtype=torch.float64):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(cfg, device, dtype)
        self.speed = float(speed)

    def pin_targets(self, k):
        """The pins after k stretches at this scene's speed: +-speed k dt
        along x."""
        move = np.zeros((len(self.pins), 3))
        move[:, 0] = self.side * self.speed * k * self.dt
        return self.rest_pins + torch.as_tensor(move, dtype=self.dtype,
                                                device=self.device)
