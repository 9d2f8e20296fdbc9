"""Data and tensor parallelism over ``torch.distributed``: the process mesh,
its collectives and the channel-sharded training forward."""
