from .audio_io import read_wav, read_wav_bytes, write_wav
from .hdf5 import (BalancedSampler, DataLoader, MultiDataLoader, RandomSampler,
                   SequentialSampler, StrongFramewiseHDF5Dataset,
                   UnlabeledRandomChunkedHDF5Dataset, WeakChunkedHDF5Dataset, WeakHDF5Dataset,
                   WeakRandomCropHDF5Dataset, collate, device_prefetch, pad_batch, to_device)
from .manifest import events_by_file, multihot, read_tsv_data
from .psl_cache import PSLCache, PSLCachedRandomCropHDF5Dataset

__all__ = [
    "BalancedSampler",
    "DataLoader",
    "MultiDataLoader",
    "PSLCache",
    "PSLCachedRandomCropHDF5Dataset",
    "RandomSampler",
    "SequentialSampler",
    "StrongFramewiseHDF5Dataset",
    "UnlabeledRandomChunkedHDF5Dataset",
    "WeakChunkedHDF5Dataset",
    "WeakHDF5Dataset",
    "WeakRandomCropHDF5Dataset",
    "collate",
    "device_prefetch",
    "events_by_file",
    "multihot",
    "pad_batch",
    "read_tsv_data",
    "read_wav",
    "read_wav_bytes",
    "to_device",
    "write_wav",
]
