from .mel import (
    FrontendConfig,
    amplitude_to_db,
    hann_window_periodic,
    log_mel_spectrogram,
    mel_filterbank,
    normalize_pcm16,
    padded_window,
    quantize_pcm16,
    reflect_pad,
    spectrogram,
)

__all__ = [
    "FrontendConfig",
    "amplitude_to_db",
    "hann_window_periodic",
    "log_mel_spectrogram",
    "mel_filterbank",
    "normalize_pcm16",
    "padded_window",
    "quantize_pcm16",
    "reflect_pad",
    "spectrogram",
]
