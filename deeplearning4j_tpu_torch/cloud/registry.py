"""Distributed configuration registry.

Reference parity: ``deeplearning4j-scaleout-zookeeper`` —
``ZooKeeperConfigurationRegister`` serializes a Configuration into a znode
path and ``ZookeeperConfigurationRetriever`` reads it back on workers.

The runtime has no ZooKeeper: every host of a pod mounts shared
storage (GCS fuse/NFS) or receives the same disk image, so the registry is
a directory of JSON documents with atomic writes — same register/retrieve
contract, no external service.  Keys are '/'-scoped like znode paths.

Port of ``deeplearning4j_tpu/cloud/registry.py``: a copy (stdlib only).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional


class ConfigRegistry:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        key = key.strip("/")
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        if not parts:
            # '', '.', '..' and slash-only keys would collapse to a path
            # OUTSIDE the registry root ('<root>.json') — refuse instead
            raise ValueError(f"empty or traversal-only registry key: {key!r}")
        return os.path.join(self.root, *parts) + ".json"

    def register(self, key: str, conf: Dict[str, Any]) -> None:
        """Atomic publish (ZooKeeperConfigurationRegister.register)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(conf, fh, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def retrieve(self, key: str) -> Dict[str, Any]:
        """ZookeeperConfigurationRetriever.retrieve parity; KeyError when
        absent (the reference throws)."""
        path = self._path(key)
        if not os.path.exists(path):
            raise KeyError(key)
        with open(path) as fh:
            return json.load(fh)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.unlink(path)

    def keys(self, prefix: str = "") -> List[str]:
        base = self.root
        out = []
        for dirpath, _, files in os.walk(base):
            for f in files:
                if not f.endswith(".json"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), base)
                key = rel[:-len(".json")].replace(os.sep, "/")
                if key.startswith(prefix.strip("/")) or not prefix:
                    out.append(key)
        return sorted(out)
