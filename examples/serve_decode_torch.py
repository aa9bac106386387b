"""Batched serving demo through the PyTorch port: prefill a batch of
prompts, decode with KV caches.

The Torch version of ``examples/serve_decode.py``: the port's serve
launcher at host-friendly sizes, across three architecture families (dense
GQA, MLA, and an attention-free SSM -- whose "cache" is an O(1) recurrent
state), on the card unless told otherwise (there the prefill's attention
runs the port's flash-attention kernel):

    PYTHONPATH=src python examples/serve_decode_torch.py                 # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu    # on the CPU
"""

import argparse

from repro_torch.launch.serve import serve

ARCHS = ["yi-6b", "deepseek-v2-lite-16b", "mamba2-1.3b"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    for arch in ARCHS:
        out = serve(arch, smoke=True, batch=4, prompt_len=32, gen=args.gen,
                    device=args.device)
        print(f"{arch:24s} prefill {out['prefill_s']*1e3:8.1f} ms | "
              f"decode {out['decode_s_per_tok']*1e3:7.2f} ms/token | "
              f"sample {out['generated'][0][:6].tolist()}")


if __name__ == "__main__":
    main()
