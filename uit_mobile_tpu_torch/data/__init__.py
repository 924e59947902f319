from .audio_io import read_wav, read_wav_bytes, write_wav
from .hdf5 import (BalancedSampler, DataLoader, MultiDataLoader, RandomSampler,
                   SequentialSampler, StrongFramewiseHDF5Dataset,
                   UnlabeledRandomChunkedHDF5Dataset, WeakChunkedHDF5Dataset, WeakHDF5Dataset,
                   WeakRandomCropHDF5Dataset, collate, device_prefetch, pad_batch, to_device)
from .manifest import events_by_file, multihot, read_tsv_data
from .prep import (LABEL_MAPS_GSC_AUDIOSET, build_audioset_manifest, dump_waves, prepare_gsc,
                   wav_duration_seconds)
from .psl_cache import PSLCache, PSLCachedRandomCropHDF5Dataset, build_psl_cache, cache_starts

__all__ = [
    "LABEL_MAPS_GSC_AUDIOSET",
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
    "build_audioset_manifest",
    "build_psl_cache",
    "cache_starts",
    "collate",
    "device_prefetch",
    "dump_waves",
    "events_by_file",
    "multihot",
    "pad_batch",
    "prepare_gsc",
    "read_tsv_data",
    "read_wav",
    "read_wav_bytes",
    "to_device",
    "wav_duration_seconds",
    "write_wav",
]
