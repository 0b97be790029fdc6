"""Readers of the benchmark's metrics.  A metric's file
(`metrics/<name>.json`) names its reader as `<module>.<function>` of this
package and gives it its parameters; a reader returns the metric's value,
or None where its run has nothing for it to read."""
