"""Speech synthesis (counterpart of ``pygpukit_tpu/tts``): Kokoro."""
