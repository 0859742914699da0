"""Model layer of the port: configs, primitives, attention, MLP, backbone."""
