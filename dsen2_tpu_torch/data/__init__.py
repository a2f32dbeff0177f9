"""Host data readers and patch-archive writers."""

from dsen2_tpu_torch.data.mat import read_scene
from dsen2_tpu_torch.data.patches_dataset import (
    interp_patches_host,
    make_val_index,
    open_data_files,
    open_data_files_test,
    save_random_patches,
    save_random_patches60,
    save_test_patches,
    save_test_patches60,
)

__all__ = [
    "read_scene",
    "interp_patches_host",
    "make_val_index",
    "open_data_files",
    "open_data_files_test",
    "save_random_patches",
    "save_random_patches60",
    "save_test_patches",
    "save_test_patches60",
]
