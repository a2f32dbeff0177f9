"""Host data readers."""

from dsen2_tpu_torch.data.mat import read_scene
from dsen2_tpu_torch.data.patches_dataset import (
    make_val_index,
    open_data_files,
    open_data_files_test,
)

__all__ = ["read_scene", "make_val_index", "open_data_files", "open_data_files_test"]
