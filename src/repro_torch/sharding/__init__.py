# Multi-device layer: the mesh handle and its trace-time context
# (`context`), the parameter and batch sharding rules (`rules`) and expert
# parallelism over a mesh's data axis (`ep`), on torch.distributed.
