"""Video reader registry (counterpart of cvnets_tpu/data/video_reader/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

VIDEO_READER_REGISTRY = Registry(registry_name="torch_video_reader")


def arguments_video_reader(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Video reader arguments")
    group.add_argument("--video-reader.name", type=str, default="frame_folder")
    return VIDEO_READER_REGISTRY.all_arguments(parser)


def get_video_reader(opts, *args, **kwargs):
    name = getattr(opts, "video_reader.name", "frame_folder") or "frame_folder"
    return VIDEO_READER_REGISTRY[name](opts, *args, **kwargs)


# registers the readers (after VIDEO_READER_REGISTRY exists)
from cvnets_tpu_torch.data.video_reader import base_av_reader  # noqa: E402,F401
