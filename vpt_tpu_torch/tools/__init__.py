"""The build tools of the port: the part-graph asset packer and the
file-tree watcher, copies of ``vpt_tpu.tools``'s."""
