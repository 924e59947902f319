from .mixup import mixup_lengths, mixup_targets, mixup_tensor, sample_mixup_lambdas
from .spec import parse_spectransforms
from .wav import parse_wavtransforms

__all__ = [
    "mixup_lengths",
    "mixup_targets",
    "mixup_tensor",
    "parse_spectransforms",
    "parse_wavtransforms",
    "sample_mixup_lambdas",
]
