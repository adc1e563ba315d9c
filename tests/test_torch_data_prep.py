"""Data preparation in the port against the JAX package: the Llama-2 chat
contract (``data.formats``), the memory-mapped token store
(``data.streaming``), the prefetch thread (``data.prefetch``) and the
``prepare_dataset`` CLI.

* ``format_conversation_for_llama2`` and ``format_llama2_system`` give the
  JAX package's strings byte for byte.
* ``write_token_store`` writes the JAX package's files byte for byte,
  unpacked and packed, across chunk boundaries, with empty documents.
* ``StreamingTokenDataset`` yields the JAX dataset's batches (every field,
  exactly), per rank as the JAX schedule slices them, after a skipped step,
  with the partial last step padded; a store of another tokenizer is
  refused. Its unpacked batches equal the in-memory dataset's, so the
  ``Trainer`` trains bit-equal on either.
* ``HostPrefetcher`` yields the source's order, bounds how far it runs
  ahead, re-raises a source failure at the consumer and closes a worker
  blocked on a full queue.
* ``cli.prepare_dataset --synthetic`` and ``--input-json`` write the JAX
  script's ``data.jsonl`` (its output without the ``datasets`` package) and
  token store byte for byte, and the same texts as the JAX script's
  ``datasets`` directory; ``cli.train`` trains from the store.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dlti_tpu.data import formats as jformats
from dlti_tpu.data import streaming as jstreaming
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.data import ByteTokenizer, formats, make_batches, streaming
from dlti_tpu_torch.data.prefetch import HostPrefetcher
from dlti_tpu_torch.training import Trainer

ROOT = Path(__file__).resolve().parents[1]
RECORDS = [{"question": "  How do I sort?  ", "answer": "Use sorted().\n"},
           {"question": "Café — naïve?", "answer": "  Ja, ünïcödé 🙂 "},
           {"question": "", "answer": ""},
           {"question": "multi\nline", "answer": "```\ncode\n```"}]


def test_llama2_chat_contract_is_byte_equal():
    for r in RECORDS:
        assert formats.format_conversation_for_llama2(r) == \
            jformats.format_conversation_for_llama2(r)
    for system in (None, "", "You are terse."):
        assert formats.format_llama2_system("q", "a", system) == \
            jformats.format_llama2_system("q", "a", system)
    assert formats.format_conversation_for_llama2(RECORDS[0])["text"] == \
        "<s>[INST] How do I sort? [/INST] Use sorted().</s>"


def _docs(n=45, seed=0):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(3, 259, rng.integers(0, 90)).tolist() for _ in range(n)]
    docs[3] = []  # an empty document
    return docs


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


@pytest.mark.parametrize("pack", [False, True])
def test_token_store_is_file_for_file_the_jax_store(tmp_path, pack):
    kw = dict(seq_len=64, pad_id=0, pack=pack, chunk_docs=16, tokenizer="byte")
    ours = streaming.write_token_store(iter(_docs()), str(tmp_path / "t"), **kw)
    theirs = jstreaming.write_token_store(iter(_docs()), str(tmp_path / "j"), **kw)
    assert ours == theirs
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert sorted(_files(tmp_path / "t")) == (
        ["ids.bin", "meta.json", "segs.bin"] if pack else ["ids.bin", "lengths.bin", "meta.json"])


def _batches(ds, epoch=1, skip=1):
    return list(ds.epoch(epoch, skip_steps=skip))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("world", [1, 2])
def test_streaming_batches_equal_the_jax_batches_per_rank(tmp_path, pack, world):
    streaming.write_token_store(iter(_docs(60)), str(tmp_path / "s"), seq_len=48, pad_id=0,
                                pack=pack, chunk_docs=16, tokenizer="byte")
    kw = dict(micro_batch_size=4, grad_accum_steps=2, shuffle_seed=3,
              drop_remainder=False)
    want = jstreaming.StreamingTokenDataset(str(tmp_path / "s"), shard_by_host=False, **kw)
    got = streaming.StreamingTokenDataset(str(tmp_path / "s"), shard_by_host=False,
                                          expect_tokenizer="byte", **kw)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    assert (got.packed, got.max_doc_len, got.seq_len) == \
        (want.packed, want.max_doc_len, want.seq_len)
    for rank in range(world):
        for ds in (want, got):
            ds._procs, ds._proc_id = world, rank
        _assert_batches_equal(_batches(got), _batches(want))
    assert _batches(got)[-1]["loss_mask"].sum() >= 0  # the padded partial step
    with pytest.raises(ValueError, match="tokenizer"):
        streaming.StreamingTokenDataset(str(tmp_path / "s"), micro_batch_size=4,
                                        expect_tokenizer="id:512")


def test_unpacked_store_batches_equal_the_in_memory_dataset_and_train_alike(tmp_path):
    texts = ["".join(chr(97 + (i * j) % 26) for j in range(3 + i % 50)) for i in range(40)]
    tok = ByteTokenizer()
    docs = [tok.encode(t, add_bos=True, add_eos=True)[:32] for t in texts]
    streaming.write_token_store(iter(docs), str(tmp_path / "s"), seq_len=32,
                                pad_id=tok.pad_id, tokenizer="byte")
    store_ds = streaming.StreamingTokenDataset(str(tmp_path / "s"), micro_batch_size=2,
                                               grad_accum_steps=2)
    mem_ds = make_batches(texts, tok, seq_len=32, micro_batch_size=2, grad_accum_steps=2)
    _assert_batches_equal(_batches(store_ds, 0, 0), _batches(mem_ds, 0, 0))
    cfg = tc.Config(model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(r=4, alpha=8),
                    data=tc.DataConfig(max_seq_len=32, tokenizer="byte"),
                    checkpoint=tc.CheckpointConfig(save_strategy="no"),
                    train=tc.TrainConfig(micro_batch_size=2, grad_accum_steps=2,
                                         max_steps=4, steps_per_sync=2))
    _, a = Trainer(cfg, device="cpu").train(dataset=store_ds)
    _, b = Trainer(cfg, device="cpu").train(dataset=mem_ds)
    assert a.losses == b.losses and len(a.losses) == 4


def test_prefetcher_keeps_order_bounds_itself_and_closes():
    made = []

    def source():
        for i in range(50):
            made.append(i)
            yield i

    pf = HostPrefetcher(source(), depth=2)
    assert list(pf) == list(range(50))
    assert pf.stats["fetches"] == 50
    pf.close()
    # Bounded: a consumer that stops reading leaves at most depth + 1 made.
    made.clear()
    pf = HostPrefetcher(source(), depth=2)
    first = next(pf)
    time.sleep(0.3)
    assert first == 0 and len(made) <= 4
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()  # idempotent
    with pytest.raises(StopIteration):
        next(pf)
    # A failure in the source re-raises at the consumer, after the batches before it.
    def broken():
        yield 1
        raise KeyError("bad row")

    pf = HostPrefetcher(broken(), depth=1)
    assert next(pf) == 1
    with pytest.raises(KeyError, match="bad row"):
        next(pf)
    pf.close()
    with pytest.raises(ValueError, match="depth"):
        HostPrefetcher([], depth=0)
    assert threading.active_count() < 50


def _run(args, **kw):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)), **kw)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _jax_script(args):
    """The JAX package's script, without the ``datasets`` package (so it
    writes the same ``data.jsonl`` as the port)."""
    code = ("import sys, runpy; sys.modules['datasets'] = None; "
            f"sys.argv = ['prepare_dataset.py'] + {list(args)!r}; "
            "runpy.run_path('scripts/prepare_dataset.py', run_name='__main__')")
    return _run(["-c", code])


@pytest.mark.parametrize("source", ["synthetic", "input_json"])
def test_prepare_dataset_writes_the_jax_scripts_files(tmp_path, source):
    if source == "synthetic":
        src = ["--synthetic", "300"]
    else:
        (tmp_path / "in.jsonl").write_text("".join(json.dumps(r) + "\n" for r in RECORDS * 5))
        src = ["--input-json", str(tmp_path / "in.jsonl")]
    common = src + ["--max-seq-len", "128", "--tokenizer", "byte", "--pack"]
    _run(["-m", "dlti_tpu_torch.cli.prepare_dataset", *common,
          "--output-dir", str(tmp_path / "t"), "--write-token-store", str(tmp_path / "ts")])
    _jax_script(common + ["--output-dir", str(tmp_path / "j"),
                          "--write-token-store", str(tmp_path / "js")])
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert _files(tmp_path / "ts") == _files(tmp_path / "js")


def test_prepare_dataset_texts_equal_the_jax_datasets_output_and_train(tmp_path):
    pytest.importorskip("datasets")
    from datasets import load_from_disk

    _run(["-m", "dlti_tpu_torch.cli.prepare_dataset", "--synthetic", "64",
          "--num-samples", "40", "--output-dir", str(tmp_path / "t"),
          "--write-token-store", str(tmp_path / "ts"), "--max-seq-len", "64"])
    _run(["scripts/prepare_dataset.py", "--synthetic", "64", "--num-samples", "40",
          "--output-dir", str(tmp_path / "j")])
    ours = [json.loads(x)["text"] for x in (tmp_path / "t" / "data.jsonl").read_text()
            .splitlines()]
    assert ours == list(load_from_disk(str(tmp_path / "j"))["text"])
    assert ours[0].startswith("<s>[INST] How do I reverse a linked list in Python? (variant 0)")
    out = _run(["-m", "dlti_tpu_torch.cli.train", "--device", "cpu", "--model", "llama_tiny",
                "--tokenizer", "byte", "--dataset-path", str(tmp_path / "ts"),
                "--max-seq-len", "64", "--per-device-batch-size", "2",
                "--gradient-accumulation-steps", "2", "--max-steps", "3",
                "--save-strategy", "no", "--output-dir", str(tmp_path / "ck"),
                "--metrics-csv", str(tmp_path / "m.csv")])
    assert "memory-mapped token store" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["windows"] == 3 and np.isfinite(summary["final_loss"])
    with pytest.raises(AssertionError, match="seq_len=64"):
        _run(["-m", "dlti_tpu_torch.cli.train", "--device", "cpu", "--model", "llama_tiny",
              "--tokenizer", "byte", "--dataset-path", str(tmp_path / "ts"),
              "--max-seq-len", "32", "--max-steps", "1", "--save-strategy", "no",
              "--output-dir", str(tmp_path / "ck"), "--metrics-csv", str(tmp_path / "m.csv")])


def test_prepare_dataset_refuses_the_hub_by_name(tmp_path):
    from dlti_tpu_torch.cli import prepare_dataset

    with pytest.raises(SystemExit, match="not ported"):
        prepare_dataset.main(["--output-dir", str(tmp_path / "x")])
