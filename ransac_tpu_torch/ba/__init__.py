"""Bundle adjustment (dense and matrix-free CG Schur) and pose graphs
(SE(3), Sim(3)): the port of ``ransac_tpu.ba``."""
