"""The classification data path (counterpart of cvnets_tpu/data): samplers,
datasets, host transforms, collate functions and the loader."""
