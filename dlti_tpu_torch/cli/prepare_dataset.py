"""Dataset preparation CLI: the port of ``scripts/prepare_dataset.py``
(Quickstart step 1). {question, answer} pairs go through the reference's
Llama-2 chat contract ``<s>[INST] q [/INST] a</s>`` (``data.formats``) into
``<output-dir>/data.jsonl`` (one ``{"text": ...}`` a line, which
``cli.train --dataset-path`` reads), and with ``--write-token-store`` also
into a memory-mapped token store (``data.streaming``) that ``cli.train``
trains from with the host holding only its row index.

Sources, first match wins:

* ``--input-json FILE``: a local JSON array or JSONL of ``{"question",
  "answer"}`` records;
* ``--synthetic N``: N deterministic synthetic code-QA pairs (the JAX
  script's, byte for byte).

Without either, the reference downloads its dataset from the hub; the port
refuses that by name (it runs without a network: see ROADMAP.md).

    python -m dlti_tpu_torch.cli.prepare_dataset --synthetic 2000 \\
        --output-dir data/synth --write-token-store data/synth_tokens \\
        --tokenizer byte --max-seq-len 512

The JAX script writes an HF ``save_to_disk`` directory when ``datasets``
is importable and else the same ``data.jsonl`` as this one; the token
stores of the two are file for file equal.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from dlti_tpu_torch.data.formats import format_conversation_for_llama2


def synthetic_pairs(n: int) -> list:
    """Deterministic synthetic code-QA corpus (the JAX script's)."""
    topics = ["reverse a linked list", "binary search", "merge two sorted arrays",
              "detect a cycle in a graph", "compute a moving average",
              "parse a CSV line", "memoize a function", "flatten a nested list"]
    langs = ["Python", "C++", "Go", "Rust", "JavaScript"]
    pairs = []
    for i in range(n):
        t, lang = topics[i % len(topics)], langs[(i // len(topics)) % len(langs)]
        pairs.append({
            "question": f"How do I {t} in {lang}? (variant {i})",
            "answer": f"Here is one way to {t} in {lang}:\n\n"
                      f"```\n# variant {i}\ndef solution(x):\n    return x\n```",
        })
    return pairs


def load_pairs(args) -> list:
    if args.input_json:
        with open(args.input_json) as f:
            head = f.read(256).lstrip()[:1]
            f.seek(0)
            if head == "[":
                records = json.load(f)
            else:
                records = [json.loads(line) for line in f if line.strip()]
        return [{"question": r["question"], "answer": r["answer"]} for r in records]
    if args.synthetic:
        return synthetic_pairs(args.synthetic)
    raise SystemExit("downloading glaiveai/glaive-code-assistant from the hub is not "
                     "ported (see ROADMAP.md): pass --input-json FILE or --synthetic N")


def prepare_dataset(args) -> str:
    t0 = time.time()
    pairs = load_pairs(args)
    if args.num_samples and args.num_samples < len(pairs):
        pairs = pairs[:args.num_samples]
    texts = [format_conversation_for_llama2(p)["text"] for p in pairs]
    rate = len(texts) / max(time.time() - t0, 1e-9)
    print(f"formatted {len(texts)} examples ({rate:,.0f} examples/s)")

    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "data.jsonl")
    with open(out, "w") as f:
        for t in texts:
            f.write(json.dumps({"text": t}) + "\n")
    total_chars = sum(len(t) for t in texts)
    print(f"saved -> {out}  ({len(texts)} rows, {total_chars / 1e6:.1f} MB of text)")

    if args.write_token_store:
        from dlti_tpu_torch.data import get_tokenizer
        from dlti_tpu_torch.data.streaming import write_token_store

        tok = get_tokenizer(args.tokenizer)
        t1 = time.time()

        def docs():
            # One document at a time: the writer holds one chunk of rows.
            for t in texts:
                yield tok.encode(t, add_bos=True, add_eos=True)[:args.max_seq_len]

        meta = write_token_store(docs(), args.write_token_store, seq_len=args.max_seq_len,
                                 pad_id=tok.pad_id, pack=args.pack,
                                 tokenizer=args.tokenizer)
        print(f"token store -> {args.write_token_store}  ({meta['n_rows']} rows x "
              f"{args.max_seq_len}, packed={args.pack}, {time.time() - t1:.1f}s)")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dataset preparation (PyTorch port)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--num-samples", "--num_samples", type=int, default=None,
                   help="subsample to N examples (default: all)")
    p.add_argument("--output-dir", "--output_dir", default="data/glaive_code_full")
    p.add_argument("--input-json", default=None,
                   help="local JSON/JSONL with question/answer records")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic pairs")
    p.add_argument("--write-token-store", default=None, metavar="DIR",
                   help="also tokenize into a memory-mapped token store "
                        "(cli.train --dataset-path reads it)")
    p.add_argument("--tokenizer", default="byte",
                   help="tokenizer for --write-token-store ('byte' or 'id[:vocab]')")
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--pack", action="store_true",
                   help="pack documents when writing the token store")
    return p.parse_args(argv)


def main(argv=None) -> None:
    prepare_dataset(parse_args(argv))


if __name__ == "__main__":
    main()
