# launch: the serving and training entry points and the production meshes
# (dry-run and analysis come with a later slice: ROADMAP.md Queue 1 item 12).
