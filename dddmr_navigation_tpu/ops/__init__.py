"""Shared device-side helpers for the stack's hot ops."""
from dddmr_navigation_tpu.ops.compaction import first_k_true_indices
