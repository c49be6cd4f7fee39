"""Checkpoint / resume for long batch jobs.

The reference is all-in-memory single-shot (SURVEY.md section 5: process
exits on any error, no resume).  Here:

* batched PSA writes per-shard results incrementally, so a preempted job
  resumes at batch granularity (``ShardedResults``);
* the MSA pipeline snapshots the POA graph per round via
  models/poa_graph.save_graph (digest-validated; see
  ops/msa_native.align_seqs(checkpoint_path=...)); ``seqs_digest`` here
  keys those snapshots to their input set.

The port's own copy of ``tsta_tpu/utils/checkpoint.py``, so that the
port imports nothing of the JAX package; the tests hold the two against
each other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional



class ShardedResults:
    """Append-only JSONL result store keyed by item name."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._done: Dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rec = json.loads(line)
                        self._done[rec["name"]] = rec

    def done(self, name: str) -> bool:
        return name in self._done

    def get(self, name: str) -> Optional[dict]:
        return self._done.get(name)

    def record(self, rec: dict) -> None:
        self._done[rec["name"]] = rec
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def results(self) -> List[dict]:
        return list(self._done.values())


def seqs_digest(seqs) -> str:
    h = hashlib.sha256()
    for s in seqs:
        h.update(len(s).to_bytes(8, "little"))
        h.update(bytes(s))
    return h.hexdigest()[:16]
