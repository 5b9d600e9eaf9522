"""Keras RPC training-backend bridge (port of ``deeplearning4j_tpu/keras/
bridge.py``).

The equivalent of the reference's ``deeplearning4j-keras`` module: an RPC
server (``Server.java``) exposing ``DeepLearning4jEntryPoint.java`` so an
external Keras process can use this framework as its training backend,
with ``HDF5MiniBatchDataSetIterator.java`` reading per-minibatch HDF5
files from a directory.

The wire is the JAX package's: newline-delimited JSON over TCP
(``{"id", "method", "params"}`` -> ``{"id", "result" | "error"}``), which
any Keras-side caller can produce with the stdlib; methods whose name
starts with ``_`` are refused.  Methods mirror the reference entry point:

- ``sequential_fit(model_file_path, train_dir, nb_epoch)``: import a
  Keras h5, train on an HDF5 minibatch directory, return the final score
  (the reference's ``fit`` call from the Keras callback);
- ``import_model(path)`` / ``fit`` / ``predict`` / ``evaluate`` / ``save``:
  the model handle lifecycle around the importer.

The networks live on the entry point's device (``device=None``: the card,
or a ``RuntimeError`` without one; the CPU only when asked for).
``predict`` answers float32 lists of ``output()``; ``save`` writes the
port's ModelSerializer zip.  ``h5py`` is imported where an h5 file is
read, never at import: without it ``import_model``, ``sequential_fit``,
``fit`` and ``evaluate`` answer an error naming ``h5py``, and
``predict``/``save`` of a network registered in process
(:meth:`KerasBridgeServer.register`) still work.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
from typing import Dict, List, Optional

import numpy as np

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator
from ..device import DeviceLike, resolve_device
from .keras_model_import import (import_keras_model_and_weights,
                                 import_keras_sequential_model_and_weights)


class HDF5MiniBatchDataSetIterator(DataSetIterator):
    """Directory of per-minibatch ``.h5`` files, each holding ``features``
    and (optionally) ``labels`` datasets, iterated in sorted filename
    order (reference ``HDF5MiniBatchDataSetIterator.java``)."""

    def __init__(self, directory: str):
        import h5py                      # at use: the module imports without
        self._h5py = h5py
        self.directory = directory
        self.paths: List[str] = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.endswith((".h5", ".hdf5")))
        if not self.paths:
            raise ValueError(f"no .h5 minibatch files in {directory}")
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        with self._h5py.File(self.paths[0], "r") as f:
            return int(f["features"].shape[0])

    def __next__(self) -> DataSet:
        if self._pos >= len(self.paths):
            raise StopIteration
        path = self.paths[self._pos]
        self._pos += 1
        with self._h5py.File(path, "r") as f:
            feats = np.asarray(f["features"], np.float32)
            labels = (np.asarray(f["labels"], np.float32)
                      if "labels" in f else None)
        ds = DataSet(feats, labels)
        return self._pre(ds)


class KerasBridgeEntryPoint:
    """The RPC-callable surface (reference
    ``DeepLearning4jEntryPoint.java``)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._models: Dict[str, object] = {}
        self._next_id = 0
        self._lock = threading.Lock()   # ThreadingTCPServer: one thread
        #                                 per connection shares this entry

    # -- the reference's one-shot fit call ---------------------------------
    def sequential_fit(self, model_file_path: str, train_dir: str,
                       nb_epoch: int = 1) -> dict:
        net = import_keras_sequential_model_and_weights(
            model_file_path, train_config=True, device=self.device)
        it = HDF5MiniBatchDataSetIterator(train_dir)
        net.fit(it, epochs=int(nb_epoch))
        handle = self._register(net)
        return {"model_id": handle, "score": float(net.score())}

    # -- handle lifecycle --------------------------------------------------
    def _register(self, net) -> str:
        with self._lock:
            handle = f"model_{self._next_id}"
            self._next_id += 1
            self._models[handle] = net
        return handle

    def _get(self, model_id: str):
        if model_id not in self._models:
            raise KeyError(f"unknown model_id {model_id!r}")
        return self._models[model_id]

    def import_model(self, path: str, model_type: str = "sequential") -> dict:
        if model_type == "sequential":
            net = import_keras_sequential_model_and_weights(
                path, device=self.device)
        elif model_type == "functional":
            net = import_keras_model_and_weights(path, device=self.device)
        else:
            raise ValueError(f"unknown model_type {model_type!r}")
        return {"model_id": self._register(net)}

    def fit(self, model_id: str, train_dir: str, nb_epoch: int = 1) -> dict:
        net = self._get(model_id)
        net.fit(HDF5MiniBatchDataSetIterator(train_dir),
                epochs=int(nb_epoch))
        return {"score": float(net.score())}

    def predict(self, model_id: str, features: list) -> dict:
        net = self._get(model_id)
        out = net.output(np.asarray(features, np.float32))
        return {"output": out.detach().float().cpu().numpy().tolist()}

    def evaluate(self, model_id: str, data_dir: str) -> dict:
        net = self._get(model_id)
        ev = net.evaluate(HDF5MiniBatchDataSetIterator(data_dir))
        return {"accuracy": ev.accuracy(), "f1": ev.f1()}

    def save(self, model_id: str, path: str) -> dict:
        from ..utils import model_serializer
        model_serializer.write_model(self._get(model_id), path)
        return {"path": path}


class _BridgeHandler(socketserver.StreamRequestHandler):
    def handle(self):
        entry: KerasBridgeEntryPoint = self.server.entry  # type: ignore
        for raw in self.rfile:
            req = None                  # fresh per line: no stale ids
            try:
                req = json.loads(raw.decode("utf-8"))
                method = req.get("method", "")
                if method.startswith("_") or not hasattr(entry, method):
                    raise AttributeError(f"unknown method {method!r}")
                result = getattr(entry, method)(**req.get("params", {}))
                resp = {"id": req.get("id"), "result": result}
            except Exception as e:
                resp = {"id": (req.get("id")
                               if isinstance(req, dict) else None),
                        "error": repr(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))
            self.wfile.flush()


class KerasBridgeServer:
    """The RPC server (reference ``Server.java``): ``port=0`` binds an
    ephemeral port exposed as ``.port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device: DeviceLike = None):
        self.entry = KerasBridgeEntryPoint(device=device)
        self._server = socketserver.ThreadingTCPServer(
            (host, port), _BridgeHandler)
        self._server.daemon_threads = True
        self._server.entry = self.entry           # type: ignore
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def register(self, net) -> str:
        """Register an in-process network under a new handle, as the
        wire's ``import_model`` does after reading an h5 file; the wire
        cannot call this (it takes a network object)."""
        return self.entry._register(net)

    def start(self) -> "KerasBridgeServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "KerasBridgeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class KerasBridgeClient:
    """Minimal client for the JSON-over-TCP protocol (what the Keras-side
    shim uses; also exercises the wire format in tests)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._fh = self._sock.makefile("rwb")
        self._next_id = 0

    def call(self, method: str, **params):
        req_id = self._next_id
        self._next_id += 1
        self._fh.write((json.dumps(
            {"id": req_id, "method": method, "params": params}) + "\n")
            .encode("utf-8"))
        self._fh.flush()
        resp = json.loads(self._fh.readline().decode("utf-8"))
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["result"]

    def close(self) -> None:
        self._fh.close()
        self._sock.close()
