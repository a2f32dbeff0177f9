"""Host data readers."""

from dsen2_tpu_torch.data.mat import read_scene

__all__ = ["read_scene"]
