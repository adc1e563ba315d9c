"""Chat formatting: the port of ``dlti_tpu/data/formats.py``, the
reference's Llama-2 contract byte for byte:

    {"question": q, "answer": a} -> {"text": "<s>[INST] q [/INST] a</s>"}
"""

from __future__ import annotations


def format_conversation_for_llama2(example: dict) -> dict:
    """One {question, answer} record as Llama-2 chat text."""
    question = example["question"].strip()
    answer = example["answer"].strip()
    return {"text": f"<s>[INST] {question} [/INST] {answer}</s>"}


def format_llama2_system(question: str, answer: str, system: str | None = None) -> str:
    """The same with an optional system prompt (the Llama-2 spec)."""
    if system:
        return f"<s>[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{question} [/INST] {answer}</s>"
    return f"<s>[INST] {question} [/INST] {answer}</s>"
