"""Constants the port's data path shares (a copy of the part of
cvnets_tpu/constants.py it uses)."""

SUPPORTED_IMAGE_EXTNS = [".png", ".jpg", ".jpeg"]

DEFAULT_IMAGE_WIDTH = DEFAULT_IMAGE_HEIGHT = 256
