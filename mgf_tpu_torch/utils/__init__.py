"""Utility subsystems: checkpointing, slot tables, metrics (counterpart of
``mgf_tpu.utils``)."""

from mgf_tpu_torch.utils.checkpoint import load_world, save_world
from mgf_tpu_torch.utils.slots import SlotTable, slot_insert, slot_remove
from mgf_tpu_torch.utils.metrics import MetricsLog, StepTimer
