"""The device plane and the mesh group that put the router in a
broker's hot path."""
