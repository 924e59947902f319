from .audio_io import read_wav, read_wav_bytes, write_wav

__all__ = ["read_wav", "read_wav_bytes", "write_wav"]
