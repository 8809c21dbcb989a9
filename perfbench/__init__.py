"""The benchmark of ``mmla_audio_torch`` on one H100 (``README.md``)."""
