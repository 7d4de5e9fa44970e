from .manager import COL, LAYOUTS, ROW, CheckpointManager, Layout

__all__ = ["COL", "CheckpointManager", "LAYOUTS", "Layout", "ROW"]
