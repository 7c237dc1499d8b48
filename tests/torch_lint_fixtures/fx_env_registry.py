import os

A = os.environ.get("TSNE_FORCE_CPU", "")  # VIOLATION
B = os.getenv("TSNE_TRACE")  # VIOLATION
C = os.environ["TSNE_MESH_REDUCE"]  # VIOLATION
KEY = "TSNE_KNN_TILES"  # VIOLATION
D = os.environ.get(KEY)  # VIOLATION
E = os.environ.get("CUDA_HOME", "")  # clean: not a TSNE_* knob
F = dict(os.environ)  # clean: a child's environment, no read of a knob
G = os.environ.get("TSNE_FORCE_CPU")  # graftlint: disable=env-registry -- the suppressed twin
