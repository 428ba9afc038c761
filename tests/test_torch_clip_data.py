"""The port's CLIP data path against the JAX package's, on the CPU:

* the BPE tokenizer's ids equal the JAX tokenizer's on a merges file written
  into the test's directory (plain and gzipped, with and without a token →
  id json), truncation keeping EOT last;
* without a merges file, the fallback's ids are the same in two processes
  with different ``PYTHONHASHSEED`` (the JAX fallback's ``hash`` is salted
  per process; the port's is ``zlib.crc32``);
* the port's zero-shot asset is the JAX package's file, byte for byte;
* ``flickr`` (all three manifests) and ``img_text_tar`` (metadata file and
  header walk) against the JAX datasets on one temporary corpus: the same
  samples, tokens equal, images within one uint8 level (the two resamplers),
  training crops given the same draws, the unreadable image's placeholder;
  the train and val loaders' batches with 0 and 2 worker threads against the
  JAX loader's; the ``trunc_seq_len`` collate against JAX's;
* ``imagenet_zero_shot``'s class names and caption tokens against JAX's;
* ``image_text_retrieval`` and ``retrieval_cmc`` against the JAX metrics'
  numpy, through the port's gathered pairs and their one read-back.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import random
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from cvnets_tpu.options.opts import get_training_arguments as jax_args
from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGES = ["t h", "th e</w>", "p h", "ph o", "pho t", "phot o</w>", "o f</w>", "d o",
          "do g</w>", "c a", "ca t</w>", "a n", "an d</w>", "i n", "in g</w>", "r e",
          "'s</w>"]
SENTENCES = ["A photo of a dog.", "the cat   and the DOG's toy", "café &amp; crème 42!",
             "a photo of " * 12 + "the end", "", "<|startoftext|> tokens <|endoftext|>"]
CAPTIONS = ["a photo of the dog", "the cat and a dog", "photos of 3 cats",
            "a dog's ball", "the end of the photo", "a cat in the rain"]


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe")
    text = "#version: 0.2\n" + "\n".join(MERGES) + "\n"
    (root / "merges.txt").write_text(text)
    with gzip.open(root / "merges.txt.gz", "wt") as f:
        f.write(text)
    return root


def _tokenizers(extra):
    from cvnets_tpu.data.text_tokenizer.clip_tokenizer import ClipTokenizer as JaxTokenizer
    from cvnets_tpu_torch.data.text_tokenizer.clip_tokenizer import ClipTokenizer

    args = ["--model.text.context-length", "16"] + extra
    return JaxTokenizer(jax_args(args=args)), ClipTokenizer(torch_args(args=args))


@pytest.mark.parametrize("name,use_json", [("merges.txt", False), ("merges.txt.gz", False),
                                           ("merges.txt", True)])
def test_bpe_ids_equal_the_jax_tokenizers(merges, name, use_json):
    extra = ["--text-tokenizer.clip.merges-path", str(merges / name)]
    if use_json:  # a token → id table that wins over the derived vocabulary
        ref, _ = _tokenizers(extra)
        table = {tok: (i * 7919) % 50000 for i, tok in enumerate(sorted(ref.encoder))}
        (merges / "encoder.json").write_text(json.dumps(table))
        extra += ["--text-tokenizer.clip.encoder-json-path", str(merges / "encoder.json")]
    ref, port = _tokenizers(extra)
    assert (port.sot, port.eot) == (ref.sot, ref.eot)
    for sentence in SENTENCES:
        want = np.asarray(ref(sentence))
        got = port(sentence)
        assert got.dtype == torch.int64 and got.shape == (16,)
        assert got.tolist() == want.tolist(), sentence
    long = port(SENTENCES[3])
    assert long[-1] == port.eot and (long != 0).all()  # cut with EOT kept last
    assert port.encode("photo")[0] == port.encoder["photo</w>"]  # the merges applied


_FALLBACK = ("import argparse, sys; sys.path.insert(0, '.');"
             "from cvnets_tpu_torch.data.text_tokenizer.clip_tokenizer import ClipTokenizer;"
             "tok = ClipTokenizer(argparse.Namespace());"
             "print(tok('A photo of a dog, and 2 cats!').tolist())")


def test_fallback_ids_do_not_change_between_processes():
    import zlib

    procs = [subprocess.Popen([sys.executable, "-c", _FALLBACK], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**os.environ, "PYTHONHASHSEED": seed})
             for seed in ("1", "2")]
    runs = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    assert all(rc == 0 for _, _, rc in runs), runs[0][1][-2000:]
    ids = [json.loads(out.strip().splitlines()[-1]) for out, _, _ in runs]
    words = ["a", "photo", "of", "a", "dog", ",", "and", "2", "cats", "!"]
    want = [49406] + [zlib.crc32(w.encode()) % (49408 - 3) + 1 for w in words] + [49407]
    assert ids[0] == ids[1] == want + [0] * (77 - len(want))


def test_zero_shot_asset_is_the_jax_file():
    from cvnets_tpu.data.datasets.multi_modal_img_text import base_multi_modal_img_text as jax_ds
    from cvnets_tpu_torch.data.datasets.multi_modal_img_text import (
        base_multi_modal_img_text as port_ds,
    )

    with open(jax_ds._ZS_ASSET, "rb") as a, open(port_ds.ZERO_SHOT_ASSET, "rb") as b:
        assert a.read() == b.read()
    templates, names = port_ds.load_zero_shot_asset()
    assert (templates, names) == (jax_ds.ZERO_SHOT_TEMPLATES, jax_ds.IMAGENET_CLASS_NAMES)
    assert len(templates) == 80 and len(names) == 1000


def _png(rng, hw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six images (PNG and JPEG) and one unreadable file; a root a manifest,
    and two tar shards with txt and json captions and a metadata index."""
    base = tmp_path_factory.mktemp("imgtext")
    rng = np.random.default_rng(0)
    images = base / "images"
    images.mkdir()
    names = []
    for i in range(6):
        hw = (int(rng.integers(40, 90)), int(rng.integers(40, 90)))
        name = f"img_{i}.png" if i % 2 else f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(images / name)
        names.append(name)
    (images / "broken.jpg").write_bytes(b"not an image")
    names.append("broken.jpg")
    captions = CAPTIONS + ["a broken file"]
    roots = {}
    for manifest in ("captions.tsv", "captions.txt", "annotations.jsonl"):
        root = base / manifest.replace(".", "_")
        root.mkdir()
        os.symlink(images, root / "images")
        lines = [json.dumps({"image": f"images/{n}", "caption": c}) if manifest.endswith("jsonl")
                 else f"images/{n}\t{c}" for n, c in zip(names, captions)]
        (root / manifest).write_text("\n".join(lines) + "\n\n")
        roots[manifest] = str(root)
    tars = base / "tars"
    tars.mkdir()
    for s in range(2):
        with tarfile.open(tars / f"shard-{s}.tar", "w") as tf:
            for i in range(3):
                key = f"{s}_{i}"
                for member, data in ((key + ".png", _png(rng, (50 + 7 * i, 60))),
                                     (key + (".txt" if i % 2 else ".json"),
                                      (CAPTIONS[3 * s + i] if i % 2 else json.dumps(
                                          {"caption": CAPTIONS[3 * s + i]})).encode())):
                    info = tarfile.TarInfo(member)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    (tars / "index.json").write_text(json.dumps({"samples": [
        ["shard-1.tar", "1_0.png", "1_0.json"], ["shard-0.tar", "0_1.png", "0_1.txt"]]}))
    roots["tars"] = str(tars)
    return roots


def _args(root, merges, extra=()):
    return ["--dataset.name", "flickr", "--dataset.category", "multi_modal_image_text",
            "--dataset.root-train", root, "--dataset.root-val", root,
            "--dataset.train-batch-size0", "3", "--dataset.val-batch-size0", "2",
            "--sampler.bs.crop-size-width", "32", "--sampler.bs.crop-size-height", "32",
            "--image-augmentation.random-resized-crop.enable",
            "--image-augmentation.random-resized-crop.interpolation", "bilinear",
            "--text-tokenizer.name", "clip",
            "--text-tokenizer.clip.merges-path", str(merges / "merges.txt"),
            "--model.text.context-length", "16", "--common.seed", "3", *extra]


def _datasets(args, is_training):
    from cvnets_tpu.data.datasets import build_dataset_from_registry as jax_build
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry

    return (jax_build(jax_args(args=args), is_training=is_training),
            build_dataset_from_registry(torch_args(args=args), is_training=is_training))


def _same_item(got: dict, want: dict) -> None:
    assert got["targets"] == want["targets"] and got["sample_id"] == want["sample_id"]
    assert got["samples"]["text"].tolist() == np.asarray(want["samples"]["text"]).tolist()
    have = got["samples"]["image"].permute(1, 2, 0).numpy().astype(np.int32)
    ref = np.round(np.asarray(want["samples"]["image"]) * 255.0).astype(np.int32)
    assert have.shape == ref.shape and np.abs(have - ref).max() <= 1


@pytest.mark.parametrize("manifest", ["captions.tsv", "captions.txt", "annotations.jsonl"])
@pytest.mark.parametrize("is_training", [False, True])
def test_flickr_items_match_jax(corpus, merges, manifest, is_training):
    ref, port = _datasets(_args(corpus[manifest], merges), is_training)
    assert len(port) == len(ref) == 7
    assert port.samples == ref.samples
    for i in range(7):
        t = (32, 32, i)
        random.seed(i)
        want = ref[t]
        got = port.get_item(t, port.draw_params(t, random.Random(i)))
        assert got["samples"]["image"].dtype == torch.uint8
        _same_item(got, want)
    assert port[(32, 32, 6)]["targets"] == -1  # the unreadable file's placeholder
    assert not port[(32, 32, 6)]["samples"]["image"].any()


@pytest.mark.parametrize("metadata", [False, True])
def test_img_text_tar_items_match_jax(corpus, merges, metadata):
    args = _args(corpus["tars"], merges, ["--dataset.name", "img_text_tar"])
    if metadata:
        args += ["--dataset.img-text-tar.metadata-file",
                 os.path.join(corpus["tars"], "index.json")]
    ref, port = _datasets(args, is_training=False)
    assert len(port) == len(ref) == (2 if metadata else 6)
    assert port.entries == [e[:3] for e in ref._tar_entries]
    for i in range(len(port)):
        _same_item(port[(40, 32, i)], ref[(40, 32, i)])


@pytest.mark.parametrize("workers", [0, 2])
def test_loaders_give_the_jax_batches(corpus, merges, workers):
    from cvnets_tpu.data.data_loaders import create_train_val_loader as jax_loaders
    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader

    args = _args(corpus["captions.tsv"], merges, [
        "--dataset.collate-fn-name-train", "multi_modal_img_text_collate_fn",
        "--dataset.collate-fn-name-val", "multi_modal_img_text_collate_fn",
        "--dataset.multi-modal-img-text.trunc-seq-len"])
    jax_train, jax_val, jax_sampler = jax_loaders(jax_args(args=args + ["--dataset.workers", "0"]))
    jax_sampler.n_device_mult = jax_val.batch_sampler.n_device_mult = 1  # one card a process
    train, val, sampler = create_train_val_loader(
        torch_args(args=args + ["--dataset.workers", str(workers)]), device="cpu")
    for port_loader, jax_loader, seed in ((train, jax_train, "transforms:3:0"), (val, jax_val, 0)):
        random.seed(seed)
        ref = list(jax_loader)
        got = list(port_loader)
        assert len(got) == len(ref) > 0
        for b, r in zip(got, ref):
            assert b["targets"].tolist() == np.asarray(r["targets"]).tolist()
            assert -1 not in b["targets"].tolist()  # the placeholder was replaced
            text = np.asarray(r["samples"]["text"])
            assert text.shape[-1] == 16  # the 16-token bucket
            assert b["samples"]["text"].tolist() == text.tolist()
            have = b["samples"]["image"].permute(0, 2, 3, 1).numpy().astype(np.int32)
            want = np.round(np.asarray(r["samples"]["image"]) * 255.0).astype(np.int32)
            assert np.abs(have - want).max() <= 1


def test_trunc_seq_len_collate_matches_jax():
    from cvnets_tpu.data.datasets.multi_modal_img_text.base_multi_modal_img_text import (
        multi_modal_img_text_collate_fn as jax_collate,
    )
    from cvnets_tpu_torch.data.datasets.multi_modal_img_text.base_multi_modal_img_text import (
        multi_modal_img_text_collate_fn,
    )

    rng = np.random.default_rng(4)
    for lengths in ([3, 5], [3, 17], [40, 2], [77, 1], [33, 33]):
        opts_jax = jax_args(args=["--dataset.multi-modal-img-text.trunc-seq-len"])
        opts_torch = torch_args(args=["--dataset.multi-modal-img-text.trunc-seq-len"])
        items = []
        for i, n in enumerate(lengths):
            text = np.zeros(77, np.int64)
            text[:n] = rng.integers(1, 100, n)
            items.append({"samples": {"image": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
                                      "text": text}, "targets": i, "sample_id": i})
        want = jax_collate(items, opts_jax)
        got = multi_modal_img_text_collate_fn(
            [{**it, "samples": {"image": torch.from_numpy(it["samples"]["image"]),
                                "text": torch.from_numpy(it["samples"]["text"])}}
             for it in items], opts_torch)
        assert got["samples"]["text"].tolist() == np.asarray(want["samples"]["text"]).tolist()
        assert got["samples"]["text"].is_contiguous()
    off = multi_modal_img_text_collate_fn(items, torch_args(args=[]))
    assert off["samples"]["text"].shape == (2, 77)


def test_zero_shot_dataset_matches_jax(tmp_path, merges):
    from cvnets_tpu.data.datasets.multi_modal_img_text.base_multi_modal_img_text import (
        ImageNetZeroShot as JaxZeroShot,
    )
    from cvnets_tpu_torch.data.datasets.multi_modal_img_text.base_multi_modal_img_text import (
        ImageNetZeroShot,
    )

    rng = np.random.default_rng(5)
    for wnid in ("n01440764", "n01443537"):
        (tmp_path / wnid).mkdir()
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
            tmp_path / wnid / "a.png")
    args = ["--dataset.root-val", str(tmp_path), "--model.text.context-length", "16",
            "--text-tokenizer.clip.merges-path", str(merges / "merges.txt"),
            "--image-augmentation.resize.enable", "--image-augmentation.resize.size", "32"]
    for extra in ([], ["--dataset.zero-shot.class-names-file", str(tmp_path / "names.txt")]):
        (tmp_path / "names.txt").write_text("tench\nthe goldfish\n")
        ref = JaxZeroShot(jax_args(args=args + extra))
        port = ImageNetZeroShot(torch_args(args=args + extra))
        assert port.class_names == ref.class_names
        tokens = port.class_caption_tokens()
        assert tokens.shape == (2, 80, 16) and tokens.dtype == torch.int64
        assert tokens.tolist() == ref.class_caption_tokens().tolist()
        assert len(port) == len(ref) == 2 and port[(32, 32, 1)]["targets"] == 1


def test_retrieval_metrics_match_jax():
    from cvnets_tpu.metrics.extra_metrics import (
        ImageTextRetrievalMetric as JaxRetrieval,
        RetrievalCMCMetric as JaxCMC,
    )
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, pairs_to_host

    rng = np.random.default_rng(6)

    def unit(n):
        x = rng.standard_normal((n, 8)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    batches = []
    for n in (5, 7, 4):
        img = unit(n)
        batches.append({"image": img, "text": img + 0.4 * unit(n)})
    targets = [rng.integers(0, 3, b["image"].shape[0]) for b in batches]
    ref, cmc = JaxRetrieval(), JaxCMC()
    pairs = None
    metrics = build_metrics(None, ["loss", "image_text_retrieval", "retrieval_cmc"])
    for b, t in zip(batches, targets):
        ref.update(b, t)
        cmc.update(b["image"], t)
        pred = {k: torch.from_numpy(v) for k, v in b.items()}
        step = {"loss": metrics["loss"].batch_values(pred, None, {"loss": torch.tensor(1.0)}),
                "image_text_retrieval": metrics["image_text_retrieval"].batch_values(pred, None),
                "retrieval_cmc": metrics["retrieval_cmc"].batch_values(pred["image"],
                                                                      torch.from_numpy(t))}
        pairs = add_pairs(pairs, step)
    assert len(pairs["image_text_retrieval"]["image"][0]) == 3  # rows kept on the device
    stats = Statistics(None, ["loss", "image_text_retrieval", "retrieval_cmc"])
    stats.update(pairs_to_host(pairs))
    got = stats.avg_statistics()
    want = ref.compute()
    assert set(want) == {f"{d}_r{k}" for d in ("i2t", "t2i") for k in (1, 5, 10)}
    assert got["image_text_retrieval"] == pytest.approx(want, abs=1e-9)
    assert got["retrieval_cmc"] == pytest.approx(cmc.compute(), abs=1e-9)
    assert got["loss"] == 1.0
    no_text = build_metrics(None, ["image_text_retrieval"])["image_text_retrieval"]
    assert no_text.batch_values({"image": torch.zeros(2, 8), "text": None}, None) == {}
