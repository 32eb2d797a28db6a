"""Speech recognition (counterpart of ``pygpukit_tpu/asr``): Whisper."""
