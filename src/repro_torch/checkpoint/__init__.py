"""Tree checkpoints (`checkpoint.checkpoint`), ported from
`repro.checkpoint`."""
from repro_torch.checkpoint.checkpoint import (
    save_checkpoint, restore_checkpoint, latest_step)
