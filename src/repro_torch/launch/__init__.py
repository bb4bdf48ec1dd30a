# launch: the serving and training entry points, the production meshes, and
# the dry run (dryrun, analysis, opdump, report) on ranks of a fake job.
