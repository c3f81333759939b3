from portbench.reference.audio.melspec import (  # noqa: F401
    mel_chunks_for_frames,
    melspectrogram,
    num_mel_chunks,
)
