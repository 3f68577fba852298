"""Report-generation metrics: copies of ``medical_image_analysis_tpu/evalx``.

BLEU, ROUGE-L, METEOR, CIDEr (``nlg.compute_nlg_scores``) and the
rule-based CheXpert labeler (``chexbert``) are pure Python, so the port
copies them; METEOR reads the JAX package's bundled tables by path.
"""
