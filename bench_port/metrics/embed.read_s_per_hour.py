"""Stage 5.3's WAV read, seconds per hour of document audio: ``read_s`` of
the stage's phase timers (``SVECALIGN_EMBED_PROFILE=1``, traced run)."""


def read(record):
    audio_s = record.counters.get("audio_s", 0.0)
    if not audio_s or "read_s" not in record.counters:
        return None
    return record.counters["read_s"] / (audio_s / 3600.0)
