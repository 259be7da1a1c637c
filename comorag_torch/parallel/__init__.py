from comorag_torch.parallel.mesh import Mesh, build_mesh, corpus_axis_size

__all__ = ["Mesh", "build_mesh", "corpus_axis_size"]
