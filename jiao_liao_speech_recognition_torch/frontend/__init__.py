"""Audio frontend: host decode (audio_io.py), resampling on the device
(resample.py), waveform augmentation (augment.py), the log-mel features
(features.py plain, fused_frontend.py K1), SpecAugment and CMVN.

Exports as the JAX package's ``frontend/__init__.py`` does."""

from .audio_io import read_audio, read_flac, read_wav, write_wav  # noqa: F401
from .augment import augment_waveform  # noqa: F401
from .features import featurize_batch, log_mel_spectrogram, mel_filterbank  # noqa: F401
from .resample import resample  # noqa: F401
from .specaugment import spec_augment  # noqa: F401
