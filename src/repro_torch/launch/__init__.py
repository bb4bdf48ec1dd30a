# launch: the serving driver (training, dry-run and analysis drivers come
# with later slices: ROADMAP.md Queue 1 items 11 and 12).
