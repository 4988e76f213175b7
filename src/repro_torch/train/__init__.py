"""Training and serving substrate of the port: the fused LDA iteration
pipeline (``lda_step.py``), and for the LM zoo AdamW with float32 master
weights (``optimizer.py``), the accumulating train step
(``train_step.py``) and the KV-cache serve step (``serve_step.py``), on
one device."""
