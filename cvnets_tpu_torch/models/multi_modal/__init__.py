"""Multi-modal image-text models (counterpart of cvnets_tpu/models/multi_modal)."""
