"""Multi-device support: meshes, halo exchange, hosts, ZeRO-1, PartialFC."""
