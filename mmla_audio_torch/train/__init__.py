"""See the counterpart subpackage of ``mmla_audio_tpu``."""
