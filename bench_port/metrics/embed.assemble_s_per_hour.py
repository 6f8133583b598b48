"""Window assembly on the device (upload, dequantisation, gathers),
seconds per hour of document audio: ``assemble_s`` of the stage's phase
timers (``SVECALIGN_EMBED_PROFILE=1``, traced run; each phase ends in a
device synchronise)."""


def read(record):
    audio_s = record.counters.get("audio_s", 0.0)
    if not audio_s or "assemble_s" not in record.counters:
        return None
    return record.counters["assemble_s"] / (audio_s / 3600.0)
