"""Scale-out and fault injection (counterpart of
``deeplearning4j_tpu/parallel``).  Only the serving half of ``chaos.py``
is ported: ``ServingChaos`` arms faults on one decode replica.  The
mesh, the data-parallel fit, the scale-out runner and the training
fault injectors are ROADMAP A7."""
