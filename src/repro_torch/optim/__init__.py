from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamW", "AdamWState", "cosine_schedule"]
