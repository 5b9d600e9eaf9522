"""Model serialization: a zip with the JSON configuration and flat binary
params (port of ``deeplearning4j_tpu/utils/model_serializer.py``).

The container is the JAX package's, so a zip written by either package
restores in the other:

- ``configuration.json``: ``conf.to_json()``, the same bytes in both;
- ``coefficients.bin``: the flat params (``get_flat_params`` order, conv
  kernels HWIO as stored), float32 little-endian;
- ``updaterState.bin``: the flat updater state in ``jax.tree_util`` leaf
  order (``MultiLayerNetwork.get_flat_updater_state``), float32 LE;
- ``state.bin``: layer state (batch-norm running mean/var), float32 LE,
  present when a layer has state;
- ``manifest.json``: counts, iteration, epoch, whether pretraining is
  done, the ``state.bin`` layout by leaf path and offset, and each
  entry's sha256 and size.

``write_model`` takes a ``MultiLayerNetwork`` or a ``ComputationGraph``;
``restore_multi_layer_network`` and ``restore_computation_graph`` read
them back.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile

import numpy as np
import torch

from .fileio import atomic_write

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
UPDATER_BIN = "updaterState.bin"
STATE_BIN = "state.bin"
MANIFEST_JSON = "manifest.json"


class ModelSerializationError(ValueError):
    """A model zip failed validation: a truncated or oversized payload, a
    count that disagrees with the manifest or with the target network, a
    digest mismatch against the manifest, or a corrupt container."""


def _entry_digests(payload) -> dict:
    return {name: {"sha256": hashlib.sha256(data).hexdigest(),
                   "size": len(data)}
            for name, data in payload}


def write_model(net, path, save_updater: bool = True) -> None:
    """Write ``net`` (a MultiLayerNetwork or a ComputationGraph) to
    ``path`` (a file path, written atomically, or a writable binary file
    object)."""
    net.init()
    flat = net.get_flat_params().astype("<f4")
    state_flat, state_manifest = _flatten_state(net)
    payload = [(CONFIG_JSON, net.conf.to_json().encode("utf-8")),
               (COEFFICIENTS_BIN, flat.tobytes())]
    ustate = (net.get_flat_updater_state().astype("<f4") if save_updater
              else np.zeros((0,), "<f4"))
    if save_updater:
        payload.append((UPDATER_BIN, ustate.tobytes()))
    if state_flat.size:
        payload.append((STATE_BIN, state_flat.astype("<f4").tobytes()))
    manifest = {
        "framework": "deeplearning4j_tpu_torch",
        "model_class": type(net).__name__,
        "num_params": int(flat.size),
        "num_updater_values": int(ustate.size),
        "iteration": int(net.iteration),
        "epoch": int(net.epoch),
        # a restored pretrain(True) model must not pretrain again over its
        # fine-tuned weights
        "pretrain_done": bool(net._pretrain_done),
        "state": state_manifest,
        "entries": _entry_digests(payload),
    }

    def write_zip(fh) -> None:
        with zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED) as zf:
            for name, data in payload:
                zf.writestr(name, data)
            zf.writestr(MANIFEST_JSON, json.dumps(manifest, indent=2))

    if isinstance(path, (str, os.PathLike)):
        # a crash mid-write leaves the previous zip, not a torn one
        with atomic_write(os.fspath(path), "wb") as fh:
            write_zip(fh)
    else:
        write_zip(path)


def restore_multi_layer_network(path, load_updater: bool = True,
                                device=None):
    """Build the zip's network on ``device`` (the card unless ``"cpu"``)
    and load its params, updater state, layer state and counters."""
    from ..nn.conf.neural_net_configuration import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork

    with _open_model_zip(path) as zf:
        conf = MultiLayerConfiguration.from_json(
            zf.read(CONFIG_JSON).decode("utf-8"))
        net = MultiLayerNetwork(conf, device=device).init()
        _restore_into(net, zf, load_updater)
    return net


def restore_computation_graph(path, load_updater: bool = True, device=None):
    """Build the zip's ComputationGraph on ``device`` (the card unless
    ``"cpu"``) and load its params, updater state, layer state and
    counters."""
    from ..nn.computation_graph import ComputationGraph
    from ..nn.conf.computation_graph import ComputationGraphConfiguration

    with _open_model_zip(path) as zf:
        conf = ComputationGraphConfiguration.from_json(
            zf.read(CONFIG_JSON).decode("utf-8"))
        net = ComputationGraph(conf, device=device).init()
        _restore_into(net, zf, load_updater)
    return net


def _open_model_zip(path) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(path, "r")
    except zipfile.BadZipFile as exc:
        raise ModelSerializationError(
            f"{path} is not a valid model zip: {exc}") from exc


def _read_entry(zf: zipfile.ZipFile, name: str, entries) -> bytes:
    """One entry, checked against the manifest's size and sha256 where the
    manifest records them (older zips have no ``entries``)."""
    try:
        data = zf.read(name)
    except zipfile.BadZipFile as exc:
        raise ModelSerializationError(
            f"model entry {name!r} is corrupt: {exc}") from exc
    rec = (entries or {}).get(name)
    if rec is not None:
        if len(data) != int(rec["size"]):
            raise ModelSerializationError(
                f"model entry {name!r} is {len(data)} bytes; manifest "
                f"records {rec['size']}")
        digest = hashlib.sha256(data).hexdigest()
        if digest != rec["sha256"]:
            raise ModelSerializationError(
                f"model entry {name!r} sha256 mismatch: manifest "
                f"{rec['sha256'][:12]}..., payload {digest[:12]}...")
    return data


def _floats(name: str, raw: bytes) -> np.ndarray:
    if len(raw) % 4:
        raise ModelSerializationError(
            f"{name} is {len(raw)} bytes, not a whole number of float32 "
            "values; the file is truncated or corrupt")
    return np.frombuffer(raw, "<f4").astype(np.float32)


def _restore_into(net, zf: zipfile.ZipFile, load_updater: bool) -> None:
    names = set(zf.namelist())
    manifest = (json.loads(_read_entry(zf, MANIFEST_JSON, None))
                if MANIFEST_JSON in names else {})
    entries = manifest.get("entries")
    flat = _floats(COEFFICIENTS_BIN,
                   _read_entry(zf, COEFFICIENTS_BIN, entries))
    want = manifest.get("num_params")
    if want is not None and flat.size != int(want):
        raise ModelSerializationError(
            f"{COEFFICIENTS_BIN} holds {flat.size} parameters; manifest "
            f"records {want}")
    have = int(net.num_params())
    if flat.size != have:
        raise ModelSerializationError(
            f"model file holds {flat.size} parameters but the target "
            f"{type(net).__name__} has {have}; architectures differ")
    net.set_flat_params(flat)
    if load_updater and UPDATER_BIN in names:
        ustate = _floats(UPDATER_BIN, _read_entry(zf, UPDATER_BIN, entries))
        uwant = manifest.get("num_updater_values")
        if uwant is not None and ustate.size != int(uwant):
            raise ModelSerializationError(
                f"{UPDATER_BIN} holds {ustate.size} values; manifest "
                f"records {uwant}")
        if ustate.size:
            try:
                net.set_flat_updater_state(ustate)
            except ValueError as exc:
                raise ModelSerializationError(str(exc)) from exc
    if manifest:
        net.iteration = int(manifest.get("iteration", 0))
        net.epoch = int(manifest.get("epoch", 0))
        net._pretrain_done = bool(manifest.get("pretrain_done", False))
        if STATE_BIN in names and manifest.get("state"):
            sflat = _floats(STATE_BIN, _read_entry(zf, STATE_BIN, entries))
            smax = max((int(e["offset"]) + int(np.prod(e["shape"]))
                        for e in manifest["state"]), default=0)
            if smax > sflat.size:
                raise ModelSerializationError(
                    f"{STATE_BIN} holds {sflat.size} values but the state "
                    f"manifest addresses up to {smax}; the file is "
                    "truncated")
            _unflatten_state(net, sflat, manifest["state"])


def _flatten_state(net):
    """Layer state -> (flat float32 vector, manifest).  Layers in the
    network's order (a graph's ``net_state`` dict in its key order), each
    layer's leaves in ``jax.tree_util`` order (keys sorted), paths
    "key/key"; ``layer`` is the index, or the vertex name."""
    chunks, manifest, offset = [], [], 0

    def walk(i, tree, path):
        nonlocal offset
        if isinstance(tree, dict):
            for key in sorted(tree):
                walk(i, tree[key], path + [str(key)])
            return
        arr = tree.detach().float().cpu().numpy()
        manifest.append({"layer": i, "path": "/".join(path),
                         "shape": list(arr.shape), "offset": offset})
        chunks.append(arr.ravel())
        offset += arr.size

    for key, tree in net._items(net.net_state):
        walk(key, tree, [])
    if not chunks:
        return np.zeros((0,), np.float32), manifest
    return np.concatenate(chunks), manifest


def _unflatten_state(net, flat: np.ndarray, manifest) -> None:
    for entry in manifest:
        keys = entry["path"].split("/")
        shape = tuple(entry["shape"])
        size = int(np.prod(shape))
        key = entry["layer"]
        target = net.net_state[key if isinstance(net.net_state, dict)
                               else int(key)]
        for k in keys[:-1]:
            target = target[k]
        prev = target.get(keys[-1])
        value = torch.as_tensor(np.array(
            flat[entry["offset"]:entry["offset"] + size]).reshape(shape))
        if prev is not None:
            # the network's storage dtype and device (bf16 state under the
            # mixed policy round-trips through the fp32 wire)
            value = value.to(device=prev.device, dtype=prev.dtype)
        target[keys[-1]] = value
