"""COCO-protocol caption evaluation stack.

Host-side (offline) metric suite matching the reference's vendored
``coco_caption`` package (COCOEvalCap: eval.py:13-82): PTB tokenization,
BLEU-1..4, METEOR, ROUGE-L, CIDEr, CIDEr-D and SPICE.  Tokenization, BLEU,
ROUGE-L and CIDEr are pure Python (optionally C++-accelerated); METEOR and
SPICE shell out to the same Java jars the reference uses when they are
available and are skipped (with a warning) otherwise.
"""
from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import PTBTokenizer  # noqa: F401
from simpleimagecaptionzoo_tpu_torch.evalcap.cider_scorer import CiderScorer, CiderD  # noqa: F401
