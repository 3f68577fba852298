"""Write ``tests/data/report_bpe_tokenizer.json``: a byte-level BPE trained
by the JAX package's ``HFTokenizer.train_bpe`` (the ``tokenizers``
runtime) on the synthetic report corpus, vocabulary at most 4,096.

    PYTHONPATH=. python tools/make_report_tokenizer.py [out_path]

The port reads the file with its own reader
(``medical_image_analysis_tpu_torch/data/hf_tokenizer.py``);
``chip_smoke.py`` puts it beside the checkpoint it writes, and
``tests/test_torch_tokenizer.py`` holds the reader to the runtime on it.
"""

import sys

from medical_image_analysis_tpu.data.datasets import (
    learnable_synthetic_annotations,
    synthetic_annotations,
)
from medical_image_analysis_tpu.data.hf_tokenizer import HFTokenizer


def main(out: str = "tests/data/report_bpe_tokenizer.json") -> None:
    reports = [s.report for ann in (synthetic_annotations(),
                                    learnable_synthetic_annotations())
               for split in ("train", "val", "test") for s in ann[split]]
    tok = HFTokenizer.train_bpe(reports, vocab_size=4096)
    tok.save(out)
    print(f"{out}: vocabulary {tok.vocab_size}, {len(reports)} reports")


if __name__ == "__main__":
    main(*sys.argv[1:])
