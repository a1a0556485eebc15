"""Data parallelism of the port: processes for training (`dp.launch`,
`dp.DPGroup`) and threads over model replicas for serving and embedding
(`dp.ReplicaSet`). Counterpart of fabind_tpu/parallel/mesh.py."""
