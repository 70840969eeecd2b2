from .checkpoint import latest, list_steps, load_manifest, restore, save
from .manager import CheckpointManager
