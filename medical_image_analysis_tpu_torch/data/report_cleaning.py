"""Report text cleaning — exact behavioral port of the reference.

``R2GenCSR/dataset/data_helper.py:29-59`` (FieldParser.
clean_report, itself from R2Gen modules/tokenizers.py): dataset-specific
sentence splitting + punctuation stripping. These regexes define the
tokens the published BLEU/CIDEr numbers are computed over, so they are
ported verbatim as behavior (iu_xray / mimic_cxr / chinese passthrough).
"""

from __future__ import annotations

import re


def _clean_iu_xray(report: str) -> str:
    def report_cleaner(t):
        t = (
            t.replace("..", ".").replace("..", ".").replace("..", ".")
            .replace("1. ", "")
            .replace(". 2. ", ". ").replace(". 3. ", ". ")
            .replace(". 4. ", ". ").replace(". 5. ", ". ")
            .replace(" 2. ", ". ").replace(" 3. ", ". ")
            .replace(" 4. ", ". ").replace(" 5. ", ". ")
        )
        return t.strip().lower().split(". ")

    def sent_cleaner(t):
        return re.sub(
            r"[.,?;*!%^&_+():\-\[\]{}]",
            "",
            t.replace('"', "").replace("/", "").replace("\\", "")
            .replace("'", "").strip().lower(),
        )

    tokens = [
        sent_cleaner(sent)
        for sent in report_cleaner(report)
        if sent_cleaner(sent) != ""
    ]
    return " . ".join(tokens) + " ."


def _clean_mimic_cxr(report: str) -> str:
    def report_cleaner(t):
        t = t.replace("\n", " ")
        for _ in range(7):
            t = t.replace("__", "_")
        for _ in range(6):
            t = t.replace("  ", " ")
        for _ in range(8):
            t = t.replace("..", ".")
        t = (
            t.replace("1. ", "")
            .replace(". 2. ", ". ").replace(". 3. ", ". ")
            .replace(". 4. ", ". ").replace(". 5. ", ". ")
            .replace(" 2. ", ". ").replace(" 3. ", ". ")
            .replace(" 4. ", ". ").replace(" 5. ", ". ")
            .replace(":", " :")
        )
        return t.strip().lower().split(". ")

    def sent_cleaner(t):
        return re.sub(
            r"[.,?;*!%^&_+()\[\]{}]",
            "",
            t.replace('"', "").replace("/", "").replace("\\", "")
            .replace("'", "").strip().lower(),
        )

    tokens = [
        sent_cleaner(sent)
        for sent in report_cleaner(report)
        if sent_cleaner(sent) != ""
    ]
    return " . ".join(tokens) + " ."


def clean_report(report: str, dataset: str) -> str:
    if dataset == "iu_xray":
        return _clean_iu_xray(report)
    if dataset == "mimic_cxr":
        return _clean_mimic_cxr(report)
    return report  # "chinese" and others: passthrough (data_helper.py:41)
