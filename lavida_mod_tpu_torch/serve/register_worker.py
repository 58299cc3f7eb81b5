"""Manually register a worker with the controller, the port's copy of
lavida_mod_tpu/serve/register_worker.py.

Reference counterpart: llava/serve/register_worker.py (posts
{worker_name, check_heart_beat, worker_status} to
<controller>/register_worker).  Standard library only.

Usage:
  python -m lavida_mod_tpu_torch.serve.register_worker \
      --controller-address http://localhost:10000 \
      --worker-name http://localhost:21002 [--check-heart-beat]
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--controller-address", required=True)
    ap.add_argument("--worker-name", required=True)
    ap.add_argument("--check-heart-beat", action="store_true")
    args = ap.parse_args(argv)

    payload = {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    }
    req = urllib.request.Request(
        args.controller_address.rstrip("/") + "/register_worker",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200, r.status
        out = json.loads(r.read() or b"{}")
    print(out)
    return out


if __name__ == "__main__":
    main()
