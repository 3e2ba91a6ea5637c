"""HTTP front of the port's caption server (the JAX package's
``tools/serve.py``).

    python -m boficap_tpu_torch.serve_http --model log/model_best.ckpt \
        --infos_path log/infos_x_best.pkl --port 8787
    python -m boficap_tpu_torch.serve_http --random_init --seed 0 \
        --cfg configs/uic_sd.yml --port 8787 --mode SAIC
    python -m boficap_tpu_torch.serve_http --random_init \
        --cfg configs/transformer.yml --mode AIC --use_pallas 1

POST /caption with a JSON body {"features": [[...2048 floats...] x R]}
returns {"caption": "...", "seq": [...], "batch": n}.  POST /caption_bin
takes the raw little-endian feature matrix, its shape and type in the
headers X-Regions and X-Dtype (float32 | float16 | bfloat16).  GET /stats
returns latency percentiles; POST /shutdown stops the server.

``--model`` and ``--infos_path`` are a checkpoint the JAX package (or the
port's ``train/state.py``) wrote: the model's options and vocabulary come
from the infos, as the JAX package's ``tools/serve.py`` reads them.
``--random_init`` builds random weights from ``--seed`` (and, without
``--vocab``, a JSON object {id: word}, a synthetic vocabulary of
``--vocab_size`` words ``w4 ...``).  ``--mode`` picks the decode:
NAIC (bound then fill, the default), SAIC (per-phrase) or AIC (word by
word, KV-cached).  ``--use_pallas 0|1`` routes the eligible attentions
through the attention-core kernel; without it the config's ``use_pallas``
holds.  Each batch size's decode program is CaptionServer's default
``route='auto'``: the kernel program, unless the plain one, timed beside
it at warm-up, wins by more than the spread of the repeats
(``CaptionServer.routes``), as the JAX package's server times both.
"""

from __future__ import annotations

import argparse
import json
import threading

import numpy as np
import torch

_BODY_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", type=str,
                     help="model.ckpt (flax msgpack); needs --infos_path")
    src.add_argument("--random_init", action="store_true")
    p.add_argument("--infos_path", type=str, default="",
                   help="the checkpoint's infos_<id>.pkl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg", type=str, default="configs/uic_sd.yml",
                   help="model config for --random_init")
    p.add_argument("--vocab", type=str, default="",
                   help="JSON {id: word} for --random_init")
    p.add_argument("--vocab_size", type=int, default=9487,
                   help="synthetic vocabulary size for --random_init")
    p.add_argument("--mode", type=str, default="NAIC",
                   choices=["NAIC", "SAIC", "AIC"])
    p.add_argument("--use_pallas", type=int, default=None, choices=[0, 1],
                   help="attention-core kernel on the eligible attentions; "
                        "default: the config's use_pallas")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--max_regions", type=int, default=0,
                   help="region width of the feature store; 0 = the "
                        "model's max_boxes")
    p.add_argument("--max_steps", type=int, default=0,
                   help="cap decode steps: bounding (NAIC, SAIC) or AR "
                        "(AIC); 0 = max_length")
    p.add_argument("--warm", type=int, default=1)
    p.add_argument("--feature_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--pipeline", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_server(args):
    from .config import (default_config, finalize, load_config,
                         restore_saved_opt)
    from .convert import init_params, load_jax_checkpoint
    from .models import setup
    from .serve import CaptionServer
    from .train.state import safe_load

    if args.model:
        if not args.infos_path:
            raise SystemExit("--model needs --infos_path")
        with open(args.infos_path, "rb") as f:
            infos = safe_load(f)
        opt = default_config()
        opt.merge_from_dict(restore_saved_opt(infos.get("opt", {})))
        ix_to_word = infos["vocab"]
        model = setup(finalize(opt), len(ix_to_word), args.device)
        load_jax_checkpoint(args.model, model)
    else:
        cfg = load_config(args.cfg)
        ix_to_word = None
        if args.vocab:
            with open(args.vocab) as f:
                ix_to_word = {str(k): v for k, v in json.load(f).items()}
        model = init_params(cfg, len(ix_to_word) if ix_to_word
                            else args.vocab_size, seed=args.seed,
                            device=args.device)
        if ix_to_word is None:
            ix_to_word = {str(i): f"w{i}" for i in range(4, model.tgt_vocab)}
    if args.use_pallas is not None:
        model.set_attention_core(bool(args.use_pallas))
    return CaptionServer(
        model, ix_to_word, mode=args.mode, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_regions=args.max_regions or None,
        max_steps=args.max_steps or None, warm=bool(args.warm),
        feature_dtype=args.feature_dtype, pipeline=bool(args.pipeline),
        device=args.device)


def make_http_server(srv, host: str, port: int):
    """Dependency-free HTTP front (http.server + threads: each request
    blocks on its future while the batcher coalesces across connections)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._json(200, srv.stats())
            return self._json(404, {"error": "GET /stats only"})

        def do_POST(self):
            if self.path == "/shutdown":
                self._json(200, {"ok": True})
                threading.Thread(target=httpd.shutdown, daemon=True).start()
                return
            if self.path not in ("/caption", "/caption_bin"):
                return self._json(404, {"error": "POST /caption[_bin]"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if self.path == "/caption_bin":
                    R = int(self.headers["X-Regions"])
                    dt_name = self.headers.get("X-Dtype", "float32")
                    if dt_name not in _BODY_DTYPES:
                        raise ValueError(
                            f"X-Dtype must be one of float32|float16|"
                            f"bfloat16, got {dt_name!r}")
                    body = bytearray(self.rfile.read(n))
                    feats = torch.frombuffer(body,
                                             dtype=_BODY_DTYPES[dt_name])
                    feats = feats.reshape(R, -1).float().numpy()
                else:
                    req = json.loads(self.rfile.read(n))
                    feats = np.asarray(req["features"], np.float32)
                if feats.ndim != 2:
                    raise ValueError(
                        f"features must be [R, feat], got {feats.shape}")
                out = srv.submit(feats).wait(timeout=600)
                self._json(200, {"caption": out["caption"],
                                 "seq": out["seq"].tolist(),
                                 "batch": out["batch"]})
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):
            pass

    class Srv(ThreadingHTTPServer):
        # a deep listen backlog: the default (5) resets connections under
        # concurrent load
        request_queue_size = 256
        daemon_threads = True

    httpd = Srv((host, port), Handler)
    return httpd


def main(argv=None):
    args = parse_args(argv)
    srv = build_server(args)
    httpd = make_http_server(srv, args.host, args.port)
    print(f"serving {args.mode} captions on http://{args.host}:"
          f"{httpd.server_address[1]} (POST /caption, POST /caption_bin, "
          f"GET /stats, POST /shutdown)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        srv.close()
        print("server stopped;", srv.stats(), flush=True)


if __name__ == "__main__":
    main()
