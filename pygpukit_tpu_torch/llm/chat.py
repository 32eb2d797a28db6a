"""Chat templating (a copy of ``pygpukit_tpu/llm/chat.py``): ChatML (Qwen),
Llama-2 ``[INST]``, Llama-3 headers and a plain fallback, and the
Llama-Guard moderation prompt. The strings are the reference's, byte for
byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

Role = Literal["system", "user", "assistant"]


@dataclass
class ChatMessage:
    role: Role
    content: str


def apply_chat_template(messages: list[ChatMessage | dict],
                        template: str = "chatml",
                        add_generation_prompt: bool = True) -> str:
    msgs = [m if isinstance(m, ChatMessage) else ChatMessage(**m) for m in messages]
    if template == "chatml":
        out = []
        for m in msgs:
            out.append(f"<|im_start|>{m.role}\n{m.content}<|im_end|>\n")
        if add_generation_prompt:
            out.append("<|im_start|>assistant\n")
        return "".join(out)
    if template == "llama2":
        sys_txt = ""
        out = []
        for m in msgs:
            if m.role == "system":
                sys_txt = f"<<SYS>>\n{m.content}\n<</SYS>>\n\n"
            elif m.role == "user":
                out.append(f"[INST] {sys_txt}{m.content} [/INST]")
                sys_txt = ""
            else:
                out.append(f" {m.content} ")
        return "<s>" + "".join(out)
    if template == "llama3":
        out = ["<|begin_of_text|>"]
        for m in msgs:
            out.append(f"<|start_header_id|>{m.role}<|end_header_id|>\n\n"
                       f"{m.content}<|eot_id|>")
        if add_generation_prompt:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)
    # plain
    body = "\n".join(f"{m.role}: {m.content}" for m in msgs)
    return body + ("\nassistant:" if add_generation_prompt else "")


def apply_guard_template(messages: list[ChatMessage | dict],
                         categories: list[str] | None = None) -> str:
    """Llama-Guard moderation prompt (reference: Llama-Guard support via the
    llama4 model family). Formats a conversation for safety classification;
    the model answers 'safe' or 'unsafe\n<category>'."""
    cats = categories or [
        "S1: Violent Crimes", "S2: Non-Violent Crimes",
        "S3: Sex-Related Crimes", "S4: Child Sexual Exploitation",
        "S5: Defamation", "S6: Specialized Advice", "S7: Privacy",
        "S8: Intellectual Property", "S9: Indiscriminate Weapons",
        "S10: Hate", "S11: Suicide & Self-Harm", "S12: Sexual Content",
        "S13: Elections",
    ]
    msgs = [m if isinstance(m, ChatMessage) else ChatMessage(**m)
            for m in messages]
    convo = "\n\n".join(
        f"{'User' if m.role == 'user' else 'Agent'}: {m.content}"
        for m in msgs if m.role != "system")
    cat_text = "\n".join(cats)
    return (
        "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\n"
        "Task: Check if there is unsafe content in the conversation below "
        "according to our safety policy with the below categories.\n\n"
        "<BEGIN UNSAFE CONTENT CATEGORIES>\n"
        f"{cat_text}\n"
        "<END UNSAFE CONTENT CATEGORIES>\n\n"
        "<BEGIN CONVERSATION>\n\n"
        f"{convo}\n\n"
        "<END CONVERSATION>\n\n"
        "Provide your safety assessment for the last turn in the above "
        "conversation:\n"
        " - First line must read 'safe' or 'unsafe'.\n"
        " - If unsafe, a second line must include a comma-separated list of "
        "violated categories.<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n")


TEMPLATES = ("chatml", "llama2", "llama3", "plain")


def format_chat_messages(messages, template: str = "chatml") -> str:
    """Alias of apply_chat_template (reference: format_chat_messages)."""
    return apply_chat_template(messages, template)


def create_chat_prompt(system: str | None, user: str,
                       template: str = "chatml") -> str:
    """A one-shot prompt: an optional system message and one user message."""
    msgs = []
    if system:
        msgs.append({"role": "system", "content": system})
    msgs.append({"role": "user", "content": user})
    return apply_chat_template(msgs, template)
